"""The port's bucketed sync (``repro_torch.dist.reference``) against the
JAX package's ``reference_sync_state`` on identical stacked leaves and
keys: two ragged buckets, 3 bits, error feedback off and on, two
consecutive steps, on the CPU.  Cases: faithful tnqsgd over 3 peers
(buckets of 592 and 2460 elements); two_phase over dp (4,) and
hierarchical over dp (2, 2), each with tnqsgd and tqsgd (two buckets of
1500: equal sizes halve the shapes JAX compiles eagerly).  The JAX side
runs eagerly except its plans, which run under ``jax.jit``: eager, every
plan recompiles the fixed-point loop.

- With the JAX plans (``QuantMeta``, the phase-2 and cross-pod plans too,
  recorded in call order) injected into the port, the mean leaves and the
  EF rows are bitwise equal: the encode, pack, residual and decode are
  exact given identical levels and uniforms, and the uniform dequant rounds
  its multiply and subtract separately in both packages.
- End to end, each package plans from its own statistics.  The tail fit
  is ill-conditioned in float32: the Hill sum subtracts ``n_tail·ln g_min``
  from the cumulative ln sums, so an ulp in those sums (XLA blocks its
  cumsum, torch accumulates it in double, and the two packages add the
  per-bin ln sums in different orders) moves α by up to 2.9e-5 relative
  (the largest of these 24 plans, measured on the CPU).  So the levels
  agree to rtol 1e-4 and the means to 1e-4·α, except on at most 0.1% of
  elements, where a moved level flips one peer's stochastic rounding:
  there the means differ by at most one level gap ÷ the peer count.  The
  two-phase and hierarchical modes quantize again after the peer mean (a
  flip there moves an element by a whole level gap) and plan from the
  chunk and pod means, whose inputs already differ by those flips; their
  bounds are one level gap per quantizing stage, and their plans, from
  inputs that differ by more than an ulp at step 2 under error feedback,
  agree to ``STAGED_PLAN_RTOL`` (largest measured: 1.5e-4, two_phase
  tnqsgd with error feedback).

PowerSGD at rank 4 with error feedback (``LOWRANK_CASES``): faithful over
3 peers, two_phase (4,) and hierarchical (2, 2) on two buckets of 1500,
and the mixed plan ``(3, ("powersgd", 4), 2)`` over three.  The powersgd
buckets' means and EF rows (residual and the warm-start aux tail) agree to
``LOWRANK_RTOL``/``LOWRANK_ATOL``; the mixed plan's quantizer buckets keep
the contract above, bitwise with JAX's plans injected and within rounding
with their own.
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
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist.reference import reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402

SHAPES = [(3, 3, 4, 16), (16,), (40, 60), (60,)]
SCALES = [1e-2, 1e-3, 3e-4, 1e-3]
STAGED_SHAPES = [(30, 50), (1500,)]
STAGED_SCALES = [1e-2, 1e-3]
BUCKET_MB = 0.01            # 2,621-element target: buckets of 592 and 2460, or 1500 and 1500
STEPS = 2
PLAN_RTOL = 1e-4
STAGED_PLAN_RTOL = 3e-4
# id -> (sync, dp_sizes, method, error feedback)
CASES = {
    "ef_off": ("faithful", (3,), "tnqsgd", False),
    "ef_on": ("faithful", (3,), "tnqsgd", True),
    **{f"{sync}-{method}-ef_{'on' if ef else 'off'}": (sync, dp, method, ef)
       for sync, dp in (("two_phase", (4,)), ("hierarchical", (2, 2)))
       for method in ("tnqsgd", "tqsgd") for ef in (False, True)},
}
_jit_plan = jax.jit(jplan_from_stats, static_argnums=0)


def _leaves(step: int, sync: str, peers: int, layout=None) -> list[np.ndarray]:
    rng = np.random.default_rng(100 + step)
    if layout is None:
        layout = (SHAPES, SCALES) if sync == "faithful" else (STAGED_SHAPES, STAGED_SCALES)
    return [(s * rng.standard_normal((peers, *shape)) * np.exp(rng.standard_normal((peers, *shape))))
            .astype(np.float32) for shape, s in zip(*layout)]


def _run_jax(sync, dp, method, ef_on, bits_plan=None, layout=None):
    ts = JTS(sync=sync, error_feedback=ef_on, bucket_mb=BUCKET_MB, bits_plan=bits_plan,
             compressor=JConfig(method=method, bits=3))
    plans, means, efs = [], [], []

    def recording(self, cfg, flat, stat, use_pallas):
        if stat is None:
            stat = jcodecs._bucket_stats(flat, use_pallas)
        meta = _jit_plan(cfg, stat[0], stat[1], stat[2])
        plans.append((np.array(meta.levels), np.array(meta.alpha)))
        return meta

    ef = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
        for step in range(STEPS):
            key = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(step))
            leaves = _leaves(step, sync, np.prod(dp), layout)
            mean, resid, _, _ = jsync(ts, [jnp.asarray(x) for x in leaves], dp, key, ef=ef)
            means.append([np.array(m) for m in mean])
            ef = resid
            efs.append(None if resid is None else [np.array(r) for r in resid])
            if ef_on and step == 0:
                ef = [jnp.asarray(r) for r in efs[-1]]
    return plans, means, efs


def _run_port(sync, dp, method, ef_on, bits_plan=None, layout=None, inject=None):
    ts = TrainStepConfig(sync=sync, error_feedback=ef_on, bucket_mb=BUCKET_MB, bits_plan=bits_plan,
                         compressor=CompressorConfig(method=method, bits=3))
    plans, means, efs = [], [], []
    orig = codecs.QuantizerCodec.plan
    queue = iter(inject or [])

    def plan(self, cfg, flat, stat):
        if inject is not None:
            lv, a = next(queue)
            return QuantMeta(levels=torch.from_numpy(lv), alpha=torch.tensor(a))
        meta = orig(self, cfg, flat, stat)
        plans.append((meta.levels.numpy().copy(), meta.alpha.numpy().copy()))
        return meta

    ef = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codecs.QuantizerCodec, "plan", plan)
        for step in range(STEPS):
            key = prng.fold_in(prng.key(0x5EED), step)
            leaves = _leaves(step, sync, np.prod(dp), layout)
            mean, ef, _, _ = reference_sync_state(
                ts, [torch.from_numpy(x) for x in leaves], dp, key, ef=ef)
            means.append([m.numpy() for m in mean])
            efs.append(None if ef is None else [r.numpy() for r in ef])
    return plans, means, efs


@pytest.fixture(scope="module", params=list(CASES.values()), ids=list(CASES))
def runs(request):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        ref = _run_jax(*request.param)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    yield (request.param, ref, _run_port(*request.param, inject=ref[0]),
           _run_port(*request.param))


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def test_injected_plans_bitwise(runs):
    (sync, dp, _, ef_on), (_, jmeans, jefs), (_, means, efs), _ = runs
    assert len(means) == STEPS and len(means[0]) == len(jmeans[0])
    for step in range(STEPS):
        for got, want in zip(means[step], jmeans[step]):
            assert got.shape == want.shape
            assert (_bits(got) == _bits(want)).all(), step
        if ef_on:
            peers = int(np.prod(dp))
            sizes = (592, 2460) if sync == "faithful" else (1500, 1500)
            assert [r.shape for r in efs[step]] == [(peers, m) for m in sizes]
            for got, want in zip(efs[step], jefs[step]):
                assert (_bits(got) == _bits(want)).all(), step
        else:
            assert efs[step] is None and jefs[step] is None


def _plans_per_step(sync: str, dp: tuple) -> int:
    """Plans per bucket and step: one per peer, plus one per phase-2 chunk
    in every pod, plus one per pod mean across pods."""
    n = int(np.prod(dp))
    if sync == "faithful":
        return n
    if sync == "two_phase" or len(dp) == 1:
        return 2 * n
    return 2 * n + n // dp[-1]


def _assert_within_rounding(sync: str, dp: tuple, plans, jplans, pairs) -> None:
    """Own plans against JAX's within ``PLAN_RTOL`` (``STAGED_PLAN_RTOL``),
    and the (got, want) means within the flips those plans allow."""
    peers = int(np.prod(dp))
    rtol = PLAN_RTOL if sync == "faithful" else STAGED_PLAN_RTOL
    for (lv, a), (jlv, ja) in zip(plans, jplans):
        np.testing.assert_allclose(a, ja, rtol=rtol)
        np.testing.assert_allclose(lv, jlv, rtol=rtol, atol=rtol * float(ja))
    alpha = max(float(a) for _, a in jplans)
    gap = max(float(np.diff(lv).max()) for lv, _ in jplans)
    diff = np.concatenate([np.abs(g - w).reshape(-1) for g, w in pairs])
    off = diff > rtol * alpha
    assert off.mean() <= 1e-3, (off.sum(), diff.size)
    # a flip moves the peer mean by gap/peers; a flip after it (phase 2, or
    # the cross-pod stage) by up to a whole gap
    bound = gap / peers if sync == "faithful" else gap * (2 if sync == "two_phase" else 3)
    assert (diff <= bound + rtol * alpha).all()


def test_end_to_end_within_rounding(runs):
    (sync, dp, _, _), (jplans, jmeans, _), _, (plans, means, _) = runs
    assert len(plans) == len(jplans) == STEPS * 2 * _plans_per_step(sync, dp)
    _assert_within_rounding(sync, dp, plans, jplans,
                            [(g, w) for step in range(STEPS) for g, w in zip(means[step], jmeans[step])])


# PowerSGD at rank 4 with error feedback: two buckets of 1500 in each mode,
# and the mixed plan over three buckets (tnqsgd at 3 bits, powersgd, tnqsgd
# at 2 bits).  Each leaf is its own bucket.
LOWRANK_SHAPES = [(30, 50), (1500,), (1500,)]
LOWRANK_SCALES = [1e-2, 1e-3, 3e-4]
MIXED_PLAN = (3, ("powersgd", 4), 2)
# id -> (sync, dp_sizes, bits_plan)
LOWRANK_CASES = {
    "powersgd-faithful": ("faithful", (3,), None),
    "powersgd-two_phase": ("two_phase", (4,), None),
    "powersgd-hierarchical": ("hierarchical", (2, 2), None),
    "mixed-faithful": ("faithful", (3,), MIXED_PLAN),
}
# The powersgd means and EF rows (residual and aux tail, each scaled by its
# own largest magnitude): the cold-start Q₀ is a few ulp from JAX's normal
# draw and the products reduce in another order than XLA's; the largest
# difference measured over these cases, on the CPU, is 6.5e-7 of the
# largest magnitude (the hierarchical mean at step 2).
LOWRANK_RTOL, LOWRANK_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", params=list(LOWRANK_CASES.values()), ids=list(LOWRANK_CASES))
def lowrank_runs(request):
    sync, dp, plan = request.param
    n = 3 if plan else 2
    args = (sync, dp, "tnqsgd" if plan else "powersgd", True, plan,
            (LOWRANK_SHAPES[:n], LOWRANK_SCALES[:n]))
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        ref = _run_jax(*args)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    yield (request.param, ref, _run_port(*args, inject=ref[0]),
           _run_port(*args) if plan else None)


def _lowrank_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=LOWRANK_RTOL,
                               atol=LOWRANK_ATOL * float(np.abs(want).max()), err_msg=what)


def test_powersgd_sync_matches_jax(lowrank_runs):
    """Means and EF rows of the powersgd buckets within tolerance; with
    JAX's plans injected, the quantizer buckets of the mixed plan bitwise."""
    (sync, dp, plan), (_, jmeans, jefs), (_, means, efs), _ = lowrank_runs
    peers, m, extra = int(np.prod(dp)), 1500, 32 * 4     # matrix_shape(1500) = (47, 32)
    entries = plan or ("powersgd",) * 2
    for step in range(STEPS):
        for b, entry in enumerate(entries):
            got, want, row, jrow = means[step][b], jmeans[step][b], efs[step][b], jefs[step][b]
            if isinstance(entry, tuple | str):
                at = f"step {step} bucket {b}"
                assert row.shape == jrow.shape == (peers, m + extra), at
                _lowrank_close(got.reshape(-1), want.reshape(-1), f"mean, {at}")
                _lowrank_close(row[:, :m], jrow[:, :m], f"EF residual, {at}")
                _lowrank_close(row[:, m:], jrow[:, m:], f"EF aux, {at}")
            else:
                assert row.shape == (peers, m)
                assert (_bits(got) == _bits(want)).all() and (_bits(row) == _bits(jrow)).all()


def test_mixed_plan_quantizer_buckets_within_rounding(lowrank_runs):
    (sync, dp, plan), (jplans, jmeans, _), _, own = lowrank_runs
    if plan is None:
        return
    plans, means, _ = own
    quant = [b for b, e in enumerate(plan) if isinstance(e, int)]
    assert len(plans) == len(jplans) == STEPS * len(quant) * int(np.prod(dp))
    _assert_within_rounding(sync, dp, plans, jplans,
                            [(means[step][b], jmeans[step][b]) for step in range(STEPS) for b in quant])
