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


def _leaves(step: int, sync: str, peers: int) -> list[np.ndarray]:
    rng = np.random.default_rng(100 + step)
    shapes, scales = (SHAPES, SCALES) if sync == "faithful" else (STAGED_SHAPES, STAGED_SCALES)
    return [(s * rng.standard_normal((peers, *shape)) * np.exp(rng.standard_normal((peers, *shape))))
            .astype(np.float32) for shape, s in zip(shapes, scales)]


def _run_jax(sync, dp, method, ef_on):
    ts = JTS(sync=sync, error_feedback=ef_on, bucket_mb=BUCKET_MB,
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
            mean, resid, _, _ = jsync(ts, [jnp.asarray(x) for x in _leaves(step, sync, np.prod(dp))], dp,
                                      key, ef=ef)
            means.append([np.array(m) for m in mean])
            ef = resid
            efs.append(None if resid is None else [np.array(r) for r in resid])
            if ef_on and step == 0:
                ef = [jnp.asarray(r) for r in efs[-1]]
    return plans, means, efs


def _run_port(sync, dp, method, ef_on, inject=None):
    ts = TrainStepConfig(sync=sync, error_feedback=ef_on, bucket_mb=BUCKET_MB,
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
            mean, ef, _, _ = reference_sync_state(
                ts, [torch.from_numpy(x) for x in _leaves(step, sync, np.prod(dp))], dp, key, ef=ef)
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


def test_end_to_end_within_rounding(runs):
    (sync, dp, _, _), (jplans, jmeans, _), _, (plans, means, _) = runs
    peers = int(np.prod(dp))
    assert len(plans) == len(jplans) == STEPS * 2 * _plans_per_step(sync, dp)
    rtol = PLAN_RTOL if sync == "faithful" else STAGED_PLAN_RTOL
    for (lv, a), (jlv, ja) in zip(plans, jplans):
        np.testing.assert_allclose(a, ja, rtol=rtol)
        np.testing.assert_allclose(lv, jlv, rtol=rtol, atol=rtol * float(ja))
    alpha = max(float(a) for _, a in jplans)
    gap = max(float(np.diff(lv).max()) for lv, _ in jplans)
    diff = np.concatenate([np.abs(g - w).reshape(-1)
                           for step in range(STEPS) for g, w in zip(means[step], jmeans[step])])
    off = diff > rtol * alpha
    assert off.mean() <= 1e-3, (off.sum(), diff.size)
    # a flip moves the peer mean by gap/peers; a flip after it (phase 2, or
    # the cross-pod stage) by up to a whole gap
    bound = gap / peers if sync == "faithful" else gap * (2 if sync == "two_phase" else 3)
    assert (diff <= bound + rtol * alpha).all()
