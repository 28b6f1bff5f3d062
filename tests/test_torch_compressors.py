"""The port's per-tensor path (``repro_torch.core.compressors`` plan/encode/
decode, ``core.error_feedback`` and ``train.train_clients``) against the
JAX package on the same numpy inputs, with JAX pinned to the port's
threefry layout.

Contract:
- ``plan`` for all six methods: g_min (the sorted quantile) and the
  density histogram bitwise; α and every level to rtol 1e-4 (atol 1e-4·α
  for levels near 0), against JAX's eager plan.  The Hill sum and the
  cumulative integrals round differently in the two packages and the tail
  fit amplifies that (ROADMAP Queue 3); measured worst: 1.3e-7.  JAX's own
  jitted plan differs from its eager one by up to 1.3e-4 in nqsgd's levels
  at n = 16 (fused multiply-adds in the cumulative integral), which is why
  the eager plan is the oracle;
- ``encode`` in both ``use_pallas`` branches, on JAX's own plan: wire
  words bitwise, at leaves on and off a multiple of 128 (the two branches
  draw different streams there);
- ``decode`` bitwise, and its two wire-shape errors;
- ``compress_with_feedback`` on a list of smallnet-shaped leaves:
  transmitted leaves and new residuals within the plans' rtol, but for at
  most one element per leaf whose rounding flips between the two plans,
  by at most one code step (measured: no flip);
- ``train_clients`` against ``benchmarks.common.train_clients`` (2 clients,
  2 rounds, batch 8, evaluation on 64), in both ``use_pallas`` branches,
  with and without EF: first loss within rtol 1e-6 (one forward pass),
  second within rtol 1e-4 (measured 3.4e-6 to 6.7e-6: the gradients round
  differently, then pass through a plan and a stochastic rounding), and
  the final models' predictions alike but for near ties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compressors as jcomp  # noqa: E402
from repro.core import distributions as jdist  # noqa: E402
from repro.core import error_feedback as jef  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import (compressors, distributions, error_feedback, prng,  # noqa: E402
                              quantizers)
from repro_torch.core.quantizers import QuantMeta  # noqa: E402

PLAN_RTOL = 1e-4
# smallnet's conv1.w (off 128) and conv2.w (a multiple of 128)
SIZES = [144, 4608]


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _heavy(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1e-3 * rng.standard_normal(n) * np.exp(rng.standard_normal(n))).astype(np.float32)


def _assert_plan(got, want):
    alpha = float(want.alpha)
    np.testing.assert_allclose(float(got.alpha), alpha, rtol=PLAN_RTOL)
    np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels), rtol=PLAN_RTOL,
                               atol=PLAN_RTOL * alpha)
    assert got.levels.dtype == torch.float32 and (torch.diff(got.levels) > 0).all()


def _meta(want) -> QuantMeta:
    return QuantMeta(levels=torch.from_numpy(np.array(want.levels)),
                     alpha=torch.from_numpy(np.array(want.alpha)))


@pytest.mark.parametrize("n", [144, 200_000])
def test_tail_and_density_match(n):
    """g_min, the density's edges and counts bitwise; γ and ρ to rtol 1e-5
    (the Hill sum); the approximate quantile within one of its log bins."""
    g = _heavy(n, n)
    want = jdist.fit_power_law_tail(jnp.asarray(g))
    got = distributions.fit_power_law_tail(torch.from_numpy(g))
    assert float(got.g_min) == float(want.g_min) and float(got.g_max) == float(want.g_max)
    np.testing.assert_allclose(float(got.gamma), float(want.gamma), rtol=1e-5)
    np.testing.assert_allclose(float(got.rho), float(want.rho), rtol=1e-6)
    jd = jdist.fit_empirical_density(jnp.asarray(g))
    td = distributions.fit_empirical_density(torch.from_numpy(g))
    assert np.array_equal(td.edges.numpy(), np.asarray(jd.edges))
    assert np.array_equal(td.density.numpy(), np.asarray(jd.density))
    gabs = np.abs(g)
    approx = float(distributions.approx_abs_quantile(torch.from_numpy(gabs), 0.9))
    np.testing.assert_allclose(approx, float(jdist.approx_abs_quantile(jnp.asarray(gabs), 0.9)),
                               rtol=1e-4)


@pytest.mark.parametrize("method", jcomp.METHODS)
@pytest.mark.parametrize("n", [144, 4608])
def test_plan_matches(method, n):
    g = _heavy(7 * n, n)
    want = jcomp.plan(jcomp.CompressorConfig(method=method), jnp.asarray(g))
    got = compressors.plan(compressors.CompressorConfig(method=method), torch.from_numpy(g))
    _assert_plan(got, want)


@pytest.mark.parametrize("method", ["tnqsgd", "tbqsgd"])
def test_plan_subsamples_past_plan_sample(method):
    """n > plan_sample: the statistics run over 64 contiguous runs, the
    same elements as JAX's ``_plan_sample``."""
    n = 200_000
    g = _heavy(11, n)
    sample = compressors._plan_sample(torch.from_numpy(g), 65_536)
    assert np.array_equal(sample.numpy(), np.asarray(jcomp._plan_sample(jnp.asarray(g), 65_536)))
    assert sample.numel() == 64 * 1024 < n
    cfg = compressors.CompressorConfig(method=method)
    _assert_plan(compressors.plan(cfg, torch.from_numpy(g)),
                 jcomp.plan(jcomp.CompressorConfig(method=method), jnp.asarray(g)))


@pytest.mark.parametrize("bits", [2, 8])
def test_biscaled_plan_from_stats_matches(bits):
    """tbqsgd now plans from the bucketed codec's one-pass statistics too
    (JAX's plan jitted)."""
    st = np.array(jref.bucket_stats(jnp.asarray(_heavy(3, 20_000))))
    want = jax.jit(lambda c, ls, m: jcomp.plan_from_stats(
        jcomp.CompressorConfig(method="tbqsgd", bits=bits), c, ls, m))(
        jnp.asarray(st[0]), jnp.asarray(st[1]), jnp.asarray(st[2, 0]))
    t = torch.from_numpy(st)
    got = compressors.plan_from_stats(compressors.CompressorConfig(method="tbqsgd", bits=bits),
                                      t[0], t[1], t[2, 0])
    _assert_plan(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", ["tnqsgd", "tqsgd"])
@pytest.mark.parametrize("n", SIZES)
def test_encode_matches_bitwise(n, method, use_pallas):
    """Both branches on JAX's own plan: the same words as JAX's branch."""
    g = _heavy(n + 1, n)
    jcfg = jcomp.CompressorConfig(method=method, use_pallas=use_pallas)
    meta = jcomp.plan(jcfg, jnp.asarray(g))
    want = np.asarray(jcomp.encode(jcfg, jnp.asarray(g), meta, jax.random.key(n)))
    cfg = compressors.CompressorConfig(method=method, use_pallas=use_pallas)
    got = compressors.encode(cfg, torch.from_numpy(g), _meta(meta), prng.key(n))
    assert got.dtype == torch.int32 and (got.numpy().view(np.uint32) == want).all()
    back = compressors.decode(cfg, got, _meta(meta), (n,)).numpy()
    assert (back.view(np.uint32) == np.asarray(
        jcomp.decode(jcfg, jnp.asarray(want), meta, (n,))).view(np.uint32)).all()


def test_branches_draw_different_streams_off_128():
    """At n = 144 the padded-tile draw and the per-element draw differ, so
    ``use_pallas`` changes the wire, as in the JAX package; ``quantize``
    (the per-element draw) equals JAX's bitwise on the same plan."""
    x = _heavy(5, 144)
    g = torch.from_numpy(x)
    cfg = compressors.CompressorConfig()
    meta = compressors.plan(cfg, g)
    on = compressors.encode(compressors.CompressorConfig(use_pallas=True), g, meta, prng.key(1))
    assert not torch.equal(on, compressors.encode(cfg, g, meta, prng.key(1)))
    jmeta = jq.QuantMeta(levels=jnp.asarray(meta.levels.numpy()),
                         alpha=jnp.asarray(meta.alpha.numpy()))
    want = np.asarray(jq.quantize(jnp.asarray(x), jmeta, jax.random.key(1)))
    assert (quantizers.quantize(g, meta, prng.key(1)).numpy().view(np.uint32)
            == want.view(np.uint32)).all()


def test_decode_rejects_wrong_wire_shapes():
    cfg = compressors.CompressorConfig(bits=3)
    meta = QuantMeta(levels=torch.linspace(-1, 1, 8), alpha=torch.tensor(1.0))
    with pytest.raises(ValueError, match="packed uint32 words"):
        compressors.decode(cfg, torch.zeros(7, dtype=torch.int32), meta, (100,))
    unpacked = compressors.CompressorConfig(bits=3, pack=False)
    with pytest.raises(ValueError, match="expected \\(100,\\) codes"):
        compressors.decode(unpacked, torch.zeros(99, dtype=torch.uint8), meta, (100,))
    codes = torch.tensor([0, 7, 3], dtype=torch.uint8)
    assert compressors.decode(unpacked, codes, meta, (3,)).tolist() == [-1.0, 1.0,
                                                                       float(meta.levels[3])]


# elements of one leaf whose stochastic rounding may flip between the
# port's plan and JAX's (levels equal to ~1e-7): measured 0 in every leaf
# of test_compress_with_feedback_matches; over round 0 of the 8-client
# loop, 2 of 1,655,376 against JAX's eager plan
MAX_FLIPS = 1


def _within_rounding(got: np.ndarray, want: np.ndarray, levels: torch.Tensor, scale: float):
    """Equal to the plans' rtol (the same code, levels that differ in the
    last bits) but for at most ``MAX_FLIPS`` elements whose stochastic
    rounding flips between the two plans, each by at most the plan's
    largest gap between adjacent levels (one code step)."""
    gap = float(torch.diff(levels).max()) * (1 + PLAN_RTOL)
    diff = np.abs(got - want)
    flips = diff > PLAN_RTOL * scale
    assert int(flips.sum()) <= MAX_FLIPS, f"{int(flips.sum())} of {flips.size} elements flip"
    assert (diff[flips] <= gap).all(), (float(diff.max()), gap)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_compress_with_feedback_matches(use_pallas):
    """EF over smallnet's two conv weights, JAX run eagerly (its jitted plan
    fuses multiply-adds and moves the levels of small leaves by up to
    1.3e-4)."""
    shapes = [(3, 3, 1, 16), (3, 3, 16, 32)]
    rng = np.random.default_rng(2)
    grads = [(1e-2 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    errs = [(1e-3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    jcfg = jcomp.CompressorConfig(use_pallas=use_pallas)
    wout, werr = jef.compress_with_feedback(jcfg, [jnp.asarray(x) for x in grads],
                                            [jnp.asarray(e) for e in errs], jax.random.key(3))
    cfg = compressors.CompressorConfig(use_pallas=use_pallas)
    out, err = error_feedback.compress_with_feedback(cfg, [torch.from_numpy(x) for x in grads],
                                                     [torch.from_numpy(e) for e in errs],
                                                     prng.key(3))
    assert [tuple(e.shape) for e in error_feedback.init_error(out)] == shapes
    for o, e, wo, we, x, x_e in zip(out, err, wout, werr, grads, errs):
        levels = compressors.plan(cfg, torch.from_numpy(x + x_e)).levels
        scale = float(np.abs(x + x_e).max())
        _within_rounding(o.numpy(), np.asarray(wo), levels, scale)
        _within_rounding(e.numpy(), np.asarray(we), levels, scale)
    leaves = compressors.tree_compress_decompress(cfg, [torch.from_numpy(x) for x in grads],
                                                  prng.key(4))
    want = jcomp.tree_compress_decompress(jcfg, [jnp.asarray(x) for x in grads],
                                          jax.random.key(4))
    for o, wo, x in zip(leaves, want, grads):
        levels = compressors.plan(cfg, torch.from_numpy(x)).levels
        _within_rounding(o.numpy(), np.asarray(wo), levels, float(np.abs(x).max()))


# smallnet's leaves but its 200,704-element fc1 weight, in tree_leaves order
LEAF_SHAPES = [(16,), (3, 3, 1, 16), (32,), (3, 3, 16, 32), (128,), (10,), (128, 10)]


@pytest.mark.parametrize("case", ["tnqsgd", "tqsgd", "qsgd", "bits_plan", "ef"])
def test_compress_decompress_leaves_equals_per_leaf_loop(case, monkeypatch):
    """``compress_decompress_leaves`` (one segmented K14 for the codebook
    leaves, one segmented K12 for the qsgd and tqsgd ones) against a loop
    of ``compress_decompress``, bit for bit on the CPU: tnqsgd, tqsgd and
    qsgd at one width, a bits_plan with mixed widths and methods (dsgd
    leaves pass through), and error feedback (``compress_with_feedback``
    against the loop on the corrected leaves)."""
    rng = np.random.default_rng(8)
    leaves = [torch.from_numpy((1e-2 * rng.standard_normal(s)).astype(np.float32))
              for s in LEAF_SHAPES]
    base = compressors.CompressorConfig(method=case if case in ("tqsgd", "qsgd") else "tnqsgd",
                                        bits=3, use_pallas=True)
    cfgs = [base] * len(leaves)
    if case == "bits_plan":
        cfgs = [compressors.CompressorConfig(method=m, bits=b, use_pallas=True) for m, b in
                (("tnqsgd", 2), ("tnqsgd", 8), ("tbqsgd", 3), ("tqsgd", 3), ("dsgd", 3),
                 ("nqsgd", 4), ("tnqsgd", 1))]
    key = prng.key(6)
    if case == "ef":
        errs = [torch.from_numpy((1e-3 * rng.standard_normal(s)).astype(np.float32))
                for s in LEAF_SHAPES]
        got, new_errs = error_feedback.compress_with_feedback(base, leaves, errs, key)
        corrected = [x + e for x, e in zip(leaves, errs)]
        want = [compressors.compress_decompress(base, x, k)
                for x, k in zip(corrected, prng.split(key, len(leaves)))]
        for e, x, w in zip(new_errs, corrected, want):
            assert torch.equal(e, x - w)
    else:
        from repro_torch.kernels import ref

        calls = {}
        for name in ("codebook_encode_segments", "uniform_encode_segments"):
            def counted(*args, _plain=getattr(ref, name), _name=name):
                calls[_name] = calls.get(_name, 0) + 1
                return _plain(*args)
            monkeypatch.setattr(ref, name, counted)
        keys = [prng.fold_in(key, j) for j in range(len(leaves))]
        got = compressors.compress_decompress_leaves(cfgs, leaves, keys)
        # one segmented encode for each kind of leaf that the configs hold
        kinds = {"tnqsgd": ["codebook"], "bits_plan": ["codebook", "uniform"]}.get(case,
                                                                                  ["uniform"])
        assert calls == {f"{k}_encode_segments": 1 for k in kinds}
        want = [compressors.compress_decompress(c, x, k) for c, x, k in zip(cfgs, leaves, keys)]
    for g, w, x in zip(got, want, leaves):
        assert g.shape == x.shape and torch.equal(g, w)


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_clients_matches_jax(use_pallas, error_feedback, monkeypatch):
    """Both encode branches, with and without EF (JAX's ``train_clients``
    builds ``CompressorConfig(method, bits)``, so its config is bound to
    ``use_pallas`` here).  The losses as the module docstring says; the
    final models are read where each loop calls ``accuracy``: the port's
    ``accuracy`` on JAX's model gives JAX's accuracy, and the two models
    predict alike on every evaluation sample but near ties, where JAX's
    top-2 logit margin is within twice the largest logit difference of the
    two models (a rounding flip in round 1 moves the weights; measured: 2
    of 64 predictions differ with use_pallas and no EF, margins 0.0065 and
    0.011 against a largest difference of 0.23)."""
    import functools
    import sys
    from pathlib import Path

    from repro_torch import train
    from repro_torch.models import smallnet

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        from benchmarks import common
    finally:
        sys.path.pop(0)

    models = {}

    def keep(side, accuracy):
        def wrapped(params, imgs, labels):
            models[side] = (params, imgs, labels)
            return accuracy(params, imgs, labels)
        return wrapped

    monkeypatch.setattr(common, "accuracy", keep("jax", common.accuracy))
    monkeypatch.setattr(train, "accuracy", keep("port", train.accuracy))
    monkeypatch.setattr(common, "CompressorConfig",
                        functools.partial(jcomp.CompressorConfig, use_pallas=use_pallas))
    kw = dict(rounds=2, n_clients=2, batch=8, eval_batch=64, error_feedback=error_feedback)
    want_acc, want = common.train_clients("tnqsgd", 3, **kw)
    acc, hist = train.train_clients("tnqsgd", 3, use_pallas=use_pallas, device="cpu", **kw)
    np.testing.assert_allclose(hist[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(hist[1], want[1], rtol=1e-4)
    params, imgs, labels = models["port"]
    jparams = smallnet.params_from_jax(models["jax"][0], device="cpu")
    assert float(smallnet.accuracy(jparams, imgs, labels)) == want_acc
    logits = smallnet.smallnet_logits(params, imgs)
    want_logits = smallnet.smallnet_logits(jparams, imgs)
    top2 = torch.topk(want_logits, 2).values
    near_tie = top2[:, 0] - top2[:, 1] <= 2 * float(torch.abs(logits - want_logits).max())
    differ = logits.argmax(1) != want_logits.argmax(1)
    assert not bool((differ & ~near_tie).any()), (differ.nonzero(), top2)
    assert abs(acc - want_acc) <= int(differ.sum()) / 64


def test_train_clients_bits_plan():
    """A per-leaf ``bits_plan``: its length is checked; at one width for
    every leaf it replays the run without it, and with EF its first round
    (zero residuals, leaf j keyed ``fold_in(key, j)``) replays it too."""
    from repro_torch.train import train_clients

    kw = dict(rounds=2, n_clients=2, batch=8, eval_batch=16, device="cpu")
    with pytest.raises(ValueError, match="8 leaves"):
        train_clients("tnqsgd", 3, bits_plan=[3, 3], **kw)
    acc, hist = train_clients("tnqsgd", 3, **kw)
    assert train_clients("tnqsgd", 2, bits_plan=[3] * 8, **kw) == (acc, hist)
    assert train_clients("tnqsgd", 3, bits_plan=[3] * 8, error_feedback=True, **kw)[1] == hist
