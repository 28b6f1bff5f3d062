"""The port's elastic sync (``reference_sync_state(live=...)``) against the
JAX package's, on the CPU.

Two buckets of 1,500 elements (leaves (30, 50) and (1500,) at
``bucket_mb=0.01``), tnqsgd at 3 bits with error feedback (random incoming
EF rows), dp (4,) for dsgd, faithful and two_phase, (2, 2) for
hierarchical.  The live masks are ``masks_for(4)`` of
``tests/test_mesh_invariance.py``: 1, 2 and 3 live peers, as a prefix and
reversed.  JAX runs each mode jitted whole with the mask a traced input,
one compilation per mode, its plans recorded in call order (this changes
no bit at 4 and 2 peers: the codebook decode has no multiply to contract
and the division by a power of two is exact).

- With JAX's plans injected, the port's means and EF rows are bitwise
  JAX's for every mask in every mode; dsgd (no plan) bitwise too.
- A dead peer cannot move the mean: its gradient times −3.7 leaves every
  mean bit as it was (faithful and two_phase, EF off; hierarchical and
  dsgd, EF on).
- Ported from ``tests/test_error_feedback.py``: under ``partition`` a dark
  peer's EF row accumulates its whole gradient each step and drains on
  rejoin; under ``solo_survivor`` every mode's mean is the survivor's own
  compressed gradient and every dead peer's EF row its whole bucket.
- ``TrainStepConfig(elastic=..., bucket_mb=0)`` and ``reference_sync(live=...)``
  on the per-leaf codec raise JAX's ``ValueError``.

About 36 s alone in one process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.core.compressors import plan_from_stats as jplan_from_stats  # noqa: E402
from repro.dist.reference import reference_sync_state as jsync  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro.elastic import ElasticConfig as JElastic  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig, bucket_concat, plan_buckets  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist.reference import reference_sync, reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402
from repro_torch.elastic import ElasticConfig, live_mask, partition, solo_survivor  # noqa: E402

SHAPES, SCALES = [(30, 50), (1500,)], [1e-2, 1e-3]
BUCKET_MB = 0.01            # 2,621-element target: two buckets of 1,500
N = 4
MODES = {"dsgd": (4,), "faithful": (4,), "two_phase": (4,), "hierarchical": (2, 2)}
BP = plan_buckets([int(np.prod(s)) for s in SHAPES],
                  TrainStepConfig(bucket_mb=BUCKET_MB).bucket_elements)


def masks_for(n):
    """``tests/test_mesh_invariance.py``'s k-of-n live subsets."""
    ks = sorted({1, max(n // 2, 1), max(n - 1, 1)})
    out = []
    for k in ks:
        m = [1.0] * k + [0.0] * (n - k)
        out.append(tuple(m))
        if k < n:
            out.append(tuple(reversed(m)))
    return sorted(set(out))


MASKS = masks_for(N)


def _inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    leaves = [(s * rng.standard_normal((N, *shape)) * np.exp(rng.standard_normal((N, *shape))))
              .astype(np.float32) for shape, s in zip(SHAPES, SCALES)]
    ef = [(1e-3 * rng.standard_normal((N, 1500))).astype(np.float32) for _ in range(2)]
    return leaves, ef


def _ts(sync: str, ef_on: bool = True, **kw):
    return dict(sync=sync, error_feedback=ef_on and sync != "dsgd", bucket_mb=BUCKET_MB, **kw)


def _jax_runner(sync: str, dp: tuple):
    """The JAX package's sync jitted whole, ``live`` traced: returns
    (means, EF rows, plans in call order)."""
    ts = JTS(**_ts(sync), compressor=JConfig(method="tnqsgd", bits=3))

    def run(key, live, leaves, ef):
        plans = []

        def recording(self, cfg, flat, stat, use_pallas):
            if stat is None:
                stat = jcodecs._bucket_stats(flat, use_pallas)
            meta = jplan_from_stats(cfg, stat[0], stat[1], stat[2])
            plans.append(meta)
            return meta

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
            mean, resid, _, _ = jsync(ts, list(leaves), dp, key,
                                      ef=None if ts.sync == "dsgd" else list(ef), live=live)
        return mean, resid, plans

    return jax.jit(run)


@pytest.fixture(scope="module", params=list(MODES))
def jax_runs(request):
    sync, dp = request.param, MODES[request.param]
    leaves, ef = _inputs()
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        run = _jax_runner(sync, dp)
        key = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(0))
        out = {}
        for live in MASKS:
            mean, resid, plans = run(key, jnp.asarray(live, jnp.float32),
                                     tuple(jnp.asarray(x) for x in leaves),
                                     tuple(jnp.asarray(e) for e in ef))
            out[live] = ([np.array(m) for m in mean],
                         None if resid is None else [np.array(r) for r in resid],
                         [(np.array(p.levels), np.array(p.alpha)) for p in plans])
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    yield sync, dp, out


def _port_sync(sync, dp, leaves, ef, live, inject=None, ef_on=True, method="tnqsgd"):
    ts = TrainStepConfig(**_ts(sync, ef_on), compressor=CompressorConfig(method=method, bits=3))
    with pytest.MonkeyPatch.context() as mp:
        if inject is not None:
            queue = iter(inject)

            def plan(self, cfg, flat, stat):
                lv, a = next(queue)
                return QuantMeta(levels=torch.from_numpy(lv), alpha=torch.tensor(a))

            mp.setattr(codecs.QuantizerCodec, "plan", plan)
        out = reference_sync_state(
            ts, [torch.as_tensor(x) for x in leaves], dp, prng.fold_in(prng.key(0x5EED), 0),
            ef=None if not ts.error_feedback else [torch.as_tensor(e) for e in ef],
            live=None if live is None else torch.tensor(live, dtype=torch.float32))
        if inject is not None:
            assert next(queue, None) is None, "the port made fewer plans than JAX"
    return out


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), np.float32).view(np.uint32)


@pytest.mark.parametrize("mask", range(len(MASKS)), ids=["".join(str(int(v)) for v in m)
                                                          for m in MASKS])
def test_masked_sync_bitwise_with_jax_plans(jax_runs, mask):
    sync, dp, out = jax_runs
    live = MASKS[mask]
    jmeans, jefs, jplans = out[live]
    leaves, ef = _inputs()
    means, efs, _, _ = _port_sync(sync, dp, leaves, ef, live, inject=jplans)
    assert len(means) == len(jmeans)
    for got, want in zip(means, jmeans):
        assert got.shape == want.shape and (_bits(got) == _bits(want)).all(), (sync, live)
    if sync == "dsgd":
        assert efs is None and jefs is None
        return
    g = _peer_buckets(leaves)
    for b, (got, want) in enumerate(zip(efs, jefs)):
        assert (_bits(got) == _bits(want)).all(), (sync, live, b)
        for p in range(N):
            if live[p] == 0.0:
                # a dead peer's EF row is its whole corrected bucket
                assert torch.equal(got[p], g[b][p] + torch.as_tensor(ef[b][p])), (sync, live, p)


def _peer_buckets(leaves) -> list:
    """Every peer's gradient in the bucket layout, stacked (n, m_b)."""
    rows = [bucket_concat([torch.as_tensor(x[p]) for x in leaves], BP) for p in range(N)]
    return [torch.stack([r[b] for r in rows]) for b in range(BP.n_buckets)]


@pytest.mark.parametrize("sync", list(MODES))
def test_dead_peer_cannot_move_the_mean(sync):
    """The straggler pin: a dead peer's encode runs, its wire is zeroed."""
    dp, ef_on = MODES[sync], sync in ("hierarchical", "dsgd")
    leaves, ef = _inputs(5)
    live = (1.0, 0.0, 1.0, 1.0)
    poked = [x.copy() for x in leaves]
    for x in poked:
        x[1] *= -3.7
    means, _, _, _ = _port_sync(sync, dp, leaves, ef, live, ef_on=ef_on)
    means2, _, _, _ = _port_sync(sync, dp, poked, ef, live, ef_on=ef_on)
    for a, b in zip(means, means2):
        assert torch.equal(a, b), sync


# the layout of tests/test_error_feedback.py's elastic tests: Gaussian
# gradients (scale 0.05) over three leaves, 1/64-MB buckets
EF_SHAPES = [(2048,), (999,), (64, 17)]
EF_BUCKET_MB = 1.0 / 64.0


def _ef_setup(sync: str, seed: int):
    ts = TrainStepConfig(sync=sync, bucket_mb=EF_BUCKET_MB, error_feedback=sync != "dsgd",
                         compressor=CompressorConfig(method="tnqsgd", bits=3))
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy((0.05 * rng.standard_normal((N, *s))).astype(np.float32))
              for s in EF_SHAPES]
    bp = plan_buckets([int(np.prod(s)) for s in EF_SHAPES], ts.bucket_elements)
    rows = [bucket_concat([x[p] for x in leaves], bp) for p in range(N)]
    g = [torch.stack([r[b] for r in rows]) for b in range(bp.n_buckets)]
    ef = [torch.zeros_like(x) for x in g] if ts.error_feedback else None
    return ts, leaves, bp, g, ef


def test_stale_ef_accumulates_and_drains_on_rejoin():
    """Peer 0 dark for 3 steps, then the fleet rejoins (faithful, 4 peers):
    the dark row holds k·g after k steps, the mean tracks the live peers'
    mean, and one rejoin step drains the backlog."""
    dark = 3
    ts, leaves, bp, g, ef = _ef_setup("faithful", 0)
    cfg = partition(N, down=(0,), down_steps=dark, up_steps=1).elastic()
    key = prng.key(42)
    for step in range(dark):
        means, ef, _, _ = reference_sync_state(ts, leaves, (N,), prng.fold_in(key, step),
                                               ef=ef, live=live_mask(cfg, step, N))
        mean_b = bucket_concat(means, bp)
        for b in range(bp.n_buckets):
            np.testing.assert_allclose(ef[b][0].numpy(), (step + 1) * g[b][0].numpy(),
                                       rtol=1e-5, atol=1e-8)
            live_mean = torch.mean(g[b][1:], dim=0)
            err = float(torch.linalg.norm(mean_b[b] - live_mean) / torch.linalg.norm(live_mean))
            assert err < 0.35, (step, b, err)
    backlog = [float(torch.linalg.norm(e[0])) for e in ef]
    lv = live_mask(cfg, dark, N)
    assert float(torch.sum(lv)) == N
    _, ef, _, _ = reference_sync_state(ts, leaves, (N,), prng.fold_in(key, dark), ef=ef, live=lv)
    for b in range(bp.n_buckets):
        assert float(torch.linalg.norm(ef[b][0])) < 0.5 * backlog[b], b


@pytest.mark.parametrize("sync", list(MODES))
def test_solo_survivor(sync):
    """k = 1: the mean is the survivor's own compressed gradient; the dead
    peers' EF rows keep their whole buckets."""
    survivor = 2
    ts, leaves, bp, g, ef = _ef_setup(sync, 3)
    live = torch.tensor(solo_survivor(N, survivor=survivor).rows[0], dtype=torch.float32)
    means, resids, _, _ = reference_sync_state(ts, leaves, MODES[sync], prng.key(7), ef=ef,
                                               live=live)
    mean_b = bucket_concat(means, bp)
    for b in range(bp.n_buckets):
        gs = g[b][survivor]
        err = float(torch.linalg.norm(mean_b[b] - gs) / torch.linalg.norm(gs))
        # two_phase and hierarchical quantize the mean again in phase 2
        assert err < (1e-6 if sync == "dsgd" else 0.5), (sync, b, err)
        if resids is not None:
            for p in range(N):
                if p != survivor:
                    assert torch.equal(resids[b][p], g[b][p]), (sync, p, b)


def test_per_leaf_codec_has_no_live_set():
    for make in (lambda: JTS(elastic=JElastic(rate=0.2), bucket_mb=0),
                 lambda: TrainStepConfig(elastic=ElasticConfig(rate=0.2), bucket_mb=0)):
        with pytest.raises(ValueError, match="elastic sync requires the bucketed codec "
                                             r"\(bucket_mb > 0\)"):
            make()
    leaves, _ = _inputs()
    ts = TrainStepConfig(sync="faithful", bucket_mb=0)
    with pytest.raises(ValueError, match="elastic live masks require the bucketed codec"):
        reference_sync(ts, [torch.as_tensor(x) for x in leaves], (N,), prng.key(0),
                       live=torch.ones(N))
