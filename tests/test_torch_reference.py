"""The port's bucketed faithful sync (``repro_torch.dist.reference``)
against the JAX package's ``reference_sync_state`` on identical stacked
leaves and keys: 3 peers, two ragged buckets (592 and 2460 elements), tnqsgd
at 3 bits, error feedback off and on, two consecutive steps, both run
eagerly on the CPU.

- With the JAX plans (``QuantMeta``) injected into the port, the mean
  leaves and the EF rows are bitwise equal: the encode, pack, residual and
  decode are exact given identical levels and uniforms.
- End to end, each package plans from its own statistics.  The tail fit
  is ill-conditioned in float32: the Hill sum subtracts ``n_tail·ln g_min``
  from the cumulative ln sums, so an ulp in those sums (XLA blocks its
  cumsum, torch accumulates it in double, and the two packages add the
  per-bin ln sums in different orders) moves α by up to 2.9e-5 relative
  (the largest of these 24 plans, measured on the CPU).  So the levels
  agree to rtol 1e-4 and the means to 1e-4·α, except on at most 0.1% of
  elements, where a moved level flips one peer's stochastic rounding:
  there the means differ by at most one level gap ÷ the peer count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.dist.reference import reference_sync_state as jsync  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist.reference import reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402

PEERS = 3
SHAPES = [(3, 3, 4, 16), (16,), (40, 60), (60,)]
SCALES = [1e-2, 1e-3, 3e-4, 1e-3]
BUCKET_MB = 0.01            # 2,621-element target: buckets of 592 and 2460
STEPS = 2
PLAN_RTOL = 1e-4


def _leaves(step: int) -> list[np.ndarray]:
    rng = np.random.default_rng(100 + step)
    return [(s * rng.standard_normal((PEERS, *shape)) * np.exp(rng.standard_normal((PEERS, *shape))))
            .astype(np.float32) for shape, s in zip(SHAPES, SCALES)]


def _run_jax(ef_on: bool):
    ts = JTS(sync="faithful", error_feedback=ef_on, bucket_mb=BUCKET_MB,
             compressor=JConfig(method="tnqsgd", bits=3))
    plans, means, efs = [], [], []
    orig = jcodecs.QuantizerCodec.plan

    def recording(self, cfg, flat, stat, use_pallas):
        meta = orig(self, cfg, flat, stat, use_pallas)
        plans.append((np.array(meta.levels), np.array(meta.alpha)))
        return meta

    ef = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
        for step in range(STEPS):
            key = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(step))
            mean, resid, _, _ = jsync(ts, [jnp.asarray(x) for x in _leaves(step)], (PEERS,), key,
                                      ef=ef)
            means.append([np.array(m) for m in mean])
            ef = resid
            efs.append(None if resid is None else [np.array(r) for r in resid])
            if ef_on and step == 0:
                ef = [jnp.asarray(r) for r in efs[-1]]
    return plans, means, efs


def _run_port(ef_on: bool, inject=None):
    ts = TrainStepConfig(sync="faithful", error_feedback=ef_on, bucket_mb=BUCKET_MB,
                         compressor=CompressorConfig(method="tnqsgd", bits=3))
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
                ts, [torch.from_numpy(x) for x in _leaves(step)], (PEERS,), key, ef=ef)
            means.append([m.numpy() for m in mean])
            efs.append(None if ef is None else [r.numpy() for r in ef])
    return plans, means, efs


@pytest.fixture(scope="module", params=[False, True], ids=["ef_off", "ef_on"])
def runs(request):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        ref = _run_jax(request.param)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    yield request.param, ref, _run_port(request.param, inject=ref[0]), _run_port(request.param)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def test_injected_plans_bitwise(runs):
    ef_on, (_, jmeans, jefs), (_, means, efs), _ = runs
    assert len(means) == STEPS and len(means[0]) == len(SHAPES)
    for step in range(STEPS):
        for got, want in zip(means[step], jmeans[step]):
            assert got.shape == want.shape
            assert (_bits(got) == _bits(want)).all(), step
        if ef_on:
            assert [r.shape for r in efs[step]] == [(PEERS, 592), (PEERS, 2460)]
            for got, want in zip(efs[step], jefs[step]):
                assert (_bits(got) == _bits(want)).all(), step
        else:
            assert efs[step] is None and jefs[step] is None


def test_end_to_end_within_rounding(runs):
    _, (jplans, jmeans, _), _, (plans, means, _) = runs
    assert len(plans) == len(jplans) == STEPS * 2 * PEERS
    for (lv, a), (jlv, ja) in zip(plans, jplans):
        np.testing.assert_allclose(a, ja, rtol=PLAN_RTOL)
        np.testing.assert_allclose(lv, jlv, rtol=PLAN_RTOL, atol=PLAN_RTOL * float(ja))
    alpha = max(float(a) for _, a in jplans)
    gap = max(float(np.diff(lv).max()) for lv, _ in jplans)
    diff = np.concatenate([np.abs(g - w).reshape(-1)
                           for step in range(STEPS) for g, w in zip(means[step], jmeans[step])])
    off = diff > PLAN_RTOL * alpha
    assert off.mean() <= 1e-3, (off.sum(), diff.size)
    assert (diff <= gap / PEERS + PLAN_RTOL * alpha).all()
