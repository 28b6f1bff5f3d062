"""The port's per-leaf codec (``reference_sync`` with ``bucket_mb=0``)
against the JAX package's on identical stacked leaves and keys, on the CPU.

Leaves of 10, 33 and 600 elements (two shorter than a 4·128 tile; 10 and
33 not multiples of the peer counts, so two_phase pads them), 3 bits.
Cases: faithful over 3 peers (tnqsgd, tqsgd, tbqsgd), two_phase over (4,)
and hierarchical over (2, 2) (tnqsgd, tqsgd).  Two_phase splits the 10-
element leaf into 4 rows of 3 and a (2, 2) pod into 2 rows of 5.

The JAX side runs its plans and its encodes under ``jax.jit`` and its
decodes eagerly (eager, every plan recompiles the fixed-point loop and
every primitive compiles for each new shape; jitted whole, XLA contracts
the uniform dequant into a multiply-add and turns the division by 3 peers
into a multiplication, which the JAX package's eager path does not do;
ROADMAP fact F7).  Its plans are recorded in call order: per leaf, each
peer's plan (faithful) or each peer's chunk-row plans then the phase-2
plans (two_phase), pod by pod, then the cross-pod plans (hierarchical).

- With JAX's plans injected into the port, the mean leaves are bitwise
  JAX's: given the levels and the keys, the draws, the encode, the pack
  and the decode are exact.
- On its own plans (from the sort-based fit, which the two packages round
  differently, ROADMAP fact F3), each mean element is within one level gap
  of JAX's plans per quantizing stage: 1 faithful, 2 two_phase, 3
  hierarchical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.core.compressors import plan as jplan  # noqa: E402
from repro.core.quantizers import QuantMeta as JMeta  # noqa: E402
from repro.dist import reference as jref  # noqa: E402
from repro.dist import sharded_codec as jsc  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist import reference, sharded_codec  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402

SHAPES = [(10,), (3, 11), (600,)]
SCALES = [1e-2, 1e-3, 3e-4]
STEP = 3
# id -> (sync, dp_sizes, method)
CASES = {
    **{f"faithful-{m}": ("faithful", (3,), m) for m in ("tnqsgd", "tqsgd", "tbqsgd")},
    **{f"{sync}-{m}": (sync, dp, m) for sync, dp in (("two_phase", (4,)),
                                                       ("hierarchical", (2, 2)))
       for m in ("tnqsgd", "tqsgd")},
}
STAGES = {"faithful": 1, "two_phase": 2, "hierarchical": 3}
_jit_plan = jax.jit(jplan, static_argnums=0)
_jit_row_plans = jax.jit(lambda cfg, rows: jax.vmap(lambda r: jplan(cfg, r))(rows),
                         static_argnums=0)
_jit_encode = jax.jit(jsc.encode_pack, static_argnums=(0, 4))
_jit_row_encodes = jax.jit(
    lambda cfg, rows, levels, alpha, keys: jax.vmap(
        lambda r, lv, a, k: jsc.encode_pack(cfg, r, JMeta(levels=lv, alpha=a), k, False))(
        rows, levels, alpha, keys), static_argnums=0)


def _leaves(peers: int) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    return [(s * rng.standard_normal((peers, *shape)) * np.exp(rng.standard_normal((peers, *shape))))
            .astype(np.float32) for shape, s in zip(SHAPES, SCALES)]


def _plans_per_leaf(sync: str, dp: tuple) -> int:
    n = int(np.prod(dp))
    if sync == "faithful":
        return n
    if sync == "two_phase":
        return n * n + n
    nd = dp[-1]
    return (n // nd) * (nd * nd + nd) + n // nd


def _run_jax(sync, dp, method):
    ts = JTS(sync=sync, bucket_mb=0, compressor=JConfig(method=method, bits=3))
    plans = []

    def plan(cfg, g):
        meta = _jit_plan(cfg, g)
        plans.append((np.array(meta.levels), np.array(meta.alpha)))
        return meta

    def plan_encode_rows(cfg, rows, key, use_pallas):
        metas = _jit_row_plans(cfg, rows)
        plans.extend(zip(np.array(metas.levels), np.array(metas.alpha)))
        keys = jax.random.split(key, rows.shape[0])
        return _jit_row_encodes(cfg, rows, metas.levels, metas.alpha, keys), metas

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jref, "plan", plan)
        mp.setattr(jsc, "_plan_encode_rows", plan_encode_rows)
        mp.setattr(jsc, "encode_pack", _jit_encode)
        key = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(STEP))
        means = jref.reference_sync(ts, [jnp.asarray(x) for x in _leaves(int(np.prod(dp)))], dp,
                                    key)
    return plans, [np.array(m) for m in means]


def _run_port(sync, dp, method, inject=None):
    ts = TrainStepConfig(sync=sync, bucket_mb=0, compressor=CompressorConfig(method=method, bits=3))
    plans, queue, orig = [], iter(inject or []), reference.plan

    def plan(cfg, g):
        if inject is not None:
            lv, a = next(queue)
            return QuantMeta(levels=torch.from_numpy(lv), alpha=torch.tensor(a))
        meta = orig(cfg, g)
        plans.append((meta.levels.numpy().copy(), meta.alpha.numpy().copy()))
        return meta

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference, "plan", plan)
        mp.setattr(sharded_codec, "plan", plan)
        key = prng.fold_in(prng.key(0x5EED), STEP)
        means = reference.reference_sync(
            ts, [torch.from_numpy(x) for x in _leaves(int(np.prod(dp)))], dp, key)
    if inject is not None:
        assert next(queue, None) is None, "the port planned fewer tensors than JAX"
    return plans, [m.numpy() for m in means]


@pytest.fixture(scope="module", params=list(CASES.values()), ids=list(CASES))
def runs(request):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        ref = _run_jax(*request.param)
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    yield request.param, ref, _run_port(*request.param, inject=ref[0]), _run_port(*request.param)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def test_injected_plans_bitwise(runs):
    (sync, dp, _), (jplans, jmeans), (_, means), _ = runs
    assert len(jplans) == len(SHAPES) * _plans_per_leaf(sync, dp)
    assert [m.shape for m in means] == SHAPES
    for got, want in zip(means, jmeans):
        assert got.shape == want.shape
        assert (_bits(got) == _bits(want)).all()


def test_own_plans_within_a_level_gap_per_stage(runs):
    (sync, dp, _), (jplans, jmeans), _, (plans, means) = runs
    per = _plans_per_leaf(sync, dp)
    assert len(plans) == len(jplans)
    for i, (got, want) in enumerate(zip(means, jmeans)):
        leaf_plans = jplans[i * per:(i + 1) * per]
        gap = max(float(np.diff(lv).max()) for lv, _ in leaf_plans)
        alpha = max(float(a) for _, a in leaf_plans)
        diff = np.abs(got - want)
        assert (diff <= STAGES[sync] * gap + 1e-4 * alpha).all(), (i, float(diff.max()), gap)


def test_dsgd_mean_and_live_mask():
    """The per-leaf dsgd mean is JAX's bit for bit; a live mask raises as
    in JAX (the per-leaf path has no live set)."""
    leaves = _leaves(3)
    want = jref.reference_sync(JTS(sync="dsgd", bucket_mb=0), [jnp.asarray(x) for x in leaves],
                               (3,), jax.random.key(0))
    ts = TrainStepConfig(sync="dsgd", bucket_mb=0)
    got = reference.reference_sync(ts, [torch.from_numpy(x) for x in leaves], (3,), prng.key(0))
    for g, w in zip(got, want):
        assert (_bits(g.numpy()) == _bits(np.array(w))).all()
    ts = TrainStepConfig(sync="faithful", bucket_mb=0)
    with pytest.raises(ValueError, match="live"):
        reference.reference_sync(ts, [torch.from_numpy(x) for x in leaves], (3,), prng.key(0),
                                 live=torch.ones(3))
