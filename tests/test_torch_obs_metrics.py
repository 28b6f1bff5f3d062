"""The port's compression metrics (``obs.metrics`` through
``reference_sync_state`` with ``metrics_compression=True``) against the
JAX package's, on the CPU.

Leaves (30, 50), (1500,) and (60,) at ``bucket_mb=0.01``: buckets of
1,500 and 1,560 elements, 4 peers, faithful sync, 3 bits, rank 4.  Cases:
tnqsgd, tqsgd, qsgd and powersgd, the fp16 tier (``fp16_threshold=1500``:
bucket 0 ships float16, bucket 1 tnqsgd) and dsgd; error feedback on
(random incoming EF rows, the powersgd aux tail too) and off; with the
live mask (1, 0, 1, 1) and without.  JAX runs each case jitted whole, one
compilation per case, and records in call order its plans (the sync's
and the metrics' own), its statistics and every peer's metric sums, which
are normalized eagerly as the source divides (jitted whole, XLA
multiplies by the reciprocal of the bucket size, one ulp apart).

- ``bits``, ``rank`` and ``wire_bytes`` are JAX's exactly.
- With JAX's plans and statistics injected: ``alpha`` and ``clip_frac``
  bitwise JAX's; a dropped peer's ``realized_mse`` is its whole corrected
  bucket's mean square; ``realized_mse`` and ``ef_norm`` within
  ``SUM_RTOL`` (the port adds its squares in a fixed pairwise tree, the
  same on a card and on the CPU, XLA in its own order: 2.7e-7 measured);
  ``predicted_mse`` within ``PRED_RTOL`` (9.3e-6 measured: the tail is
  fitted on the statistics' bin edges, which the packages round apart,
  ROADMAP facts F3 and F7); the means and EF rows bitwise JAX's for the
  codebook methods and the fp16 tier, powersgd's within the low-rank
  tolerance of ``tests/test_torch_reference.py``, tqsgd's and qsgd's
  within ``UNIFORM_ATOL`` of the largest magnitude (jitted whole, XLA
  contracts the uniform dequant into a multiply-add, fact F7;
  ``tests/test_torch_reference.py`` holds them bitwise against JAX run
  eagerly).
- End to end, each package planning from its own statistics: ``alpha``
  and ``realized_mse`` within F3's rtol 1e-4 (4.4e-5 and 7.5e-6
  measured); ``predicted_mse``, a small difference of two terms fitted
  from ln sums a few ulps apart, within ``E2E_PRED_RTOL`` (1.65e-4
  measured); ``clip_frac`` equal here, held within two elements.
- The qsgd realized error tracks its prediction, as
  ``tests/test_obs.py::test_qsgd_realized_tracks_predicted`` holds JAX's.

About 50 s alone in one process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.adaptive import telemetry as jtelemetry  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.core.compressors import plan_from_stats as jplan_from_stats  # noqa: E402
from repro.dist.reference import reference_sync_state as jsync  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.adaptive import telemetry  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig, bucket_concat, plan_buckets  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist.reference import reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

SHAPES, SCALES = [(30, 50), (1500,), (60,)], [1e-2, 1e-3, 3e-4]
SIZES = (1500, 1560)
BUCKET_MB = 0.01
N = 4
LIVE = (1.0, 0.0, 1.0, 1.0)
# relative tolerances; the largest differences measured on the CPU over
# these cases are in the module docstring
SUM_RTOL, PRED_RTOL, PLAN_RTOL, E2E_PRED_RTOL = 1e-6, 2e-5, 1e-4, 3e-4
LOWRANK_RTOL, LOWRANK_ATOL = 1e-5, 1e-6
UNIFORM_ATOL = 1e-6        # of the largest magnitude (2.5e-7 measured)
EXACT = ("bits", "rank", "wire_bytes")
# id -> (sync, dp, method, error feedback, fp16_threshold, live mask or None)
CASES = {
    "tnqsgd-ef_on-masked": ("faithful", (4,), "tnqsgd", True, 0, LIVE),
    "tnqsgd-ef_on": ("faithful", (4,), "tnqsgd", True, 0, None),
    "tnqsgd-ef_off-masked": ("faithful", (4,), "tnqsgd", False, 0, LIVE),
    "tqsgd-ef_on-masked": ("faithful", (4,), "tqsgd", True, 0, LIVE),
    "qsgd-ef_off": ("faithful", (4,), "qsgd", False, 0, None),
    "powersgd-ef_on-masked": ("faithful", (4,), "powersgd", True, 0, LIVE),
    "powersgd-ef_off": ("faithful", (4,), "powersgd", False, 0, None),
    "fp16_tier-ef_on-masked": ("faithful", (4,), "tnqsgd", True, 1500, LIVE),
    "dsgd-masked": ("dsgd", (4,), "tnqsgd", False, 0, LIVE),
    "dsgd": ("dsgd", (4,), "tnqsgd", False, 0, None),
}


def _inputs(method: str, ef_on: bool):
    rng = np.random.default_rng(17)
    leaves = [(s * rng.standard_normal((N, *shape)) * np.exp(rng.standard_normal((N, *shape))))
              .astype(np.float32) for shape, s in zip(SHAPES, SCALES)]
    if not ef_on:
        return leaves, None
    sizes = codecs.bucket_state_sizes(CompressorConfig(method=method, rank=4), SIZES)
    return leaves, [(1e-3 * rng.standard_normal((N, m))).astype(np.float32) for m in sizes]


def _kw(sync, method, ef_on, fp16):
    return dict(sync=sync, error_feedback=ef_on, bucket_mb=BUCKET_MB, fp16_threshold=fp16,
                metrics_compression=True)


def _run_jax(sync, dp, method, ef_on, fp16, live):
    ts = JTS(**_kw(sync, method, ef_on, fp16), compressor=JConfig(method=method, bits=3, rank=4))
    leaves, ef = _inputs(method, ef_on)

    statics = []

    def run(key, live, leaves, ef):
        plans, stats, sums = [], [], []
        correct_stats, finalize = jtelemetry.correct_stats, jmetrics.finalize

        def recording(self, cfg, flat, stat, use_pallas):
            if stat is None:
                stat = jcodecs._bucket_stats(flat, use_pallas)
            meta = jplan_from_stats(cfg, stat[0], stat[1], stat[2])
            plans.append(meta)
            return meta

        def recording_stats(*args, **kw):
            c, st = correct_stats(*args, **kw)
            stats.append(st)
            return c, st

        def recording_sums(peer_sums, static, n_model):
            sums.append(peer_sums)
            statics.append(static)
            return finalize(peer_sums, static, n_model)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
            mp.setattr(jtelemetry, "correct_stats", recording_stats)
            mp.setattr(jmetrics, "finalize", recording_sums)
            mean, resid, _, cm = jsync(ts, list(leaves), dp, key,
                                       ef=None if ef is None else list(ef), live=live)
        return mean, resid, cm, plans, stats, sums

    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        key = jax.random.fold_in(jax.random.key(0x5EED), jnp.uint32(0))
        mean, resid, cm, plans, stats, sums = jax.jit(run)(
            key, None if live is None else jnp.asarray(live, jnp.float32),
            tuple(jnp.asarray(x) for x in leaves),
            None if ef is None else tuple(jnp.asarray(e) for e in ef))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    # the peers' sums normalized eagerly, as the source divides: jitted
    # whole, XLA multiplies by the reciprocal of the bucket size instead
    # (one ulp apart in clip_frac and realized_mse)
    rows = [jmetrics.finalize(x, st, 1) for x, st in zip(sums, statics)]
    eager = {f: np.stack([np.array(getattr(r, f)) for r in rows]) for f in cm._fields}
    jitted = {f: np.array(v) for f, v in zip(cm._fields, cm)}
    for f in ("bits", "rank", "alpha", "wire_bytes", "predicted_mse", "ef_norm"):
        assert np.array_equal(eager[f], jitted[f]), f
    return ([np.array(m) for m in mean], None if resid is None else [np.array(r) for r in resid],
            eager,
            [(np.array(p.levels), np.array(p.alpha)) for p in plans],
            [tuple(np.array(x) for x in st) for st in stats])


def _run_port(sync, dp, method, ef_on, fp16, live, inject=None, inject_stats=None):
    ts = TrainStepConfig(**_kw(sync, method, ef_on, fp16),
                         compressor=CompressorConfig(method=method, bits=3, rank=4))
    leaves, ef = _inputs(method, ef_on)
    plans = []
    orig, correct_stats = codecs.QuantizerCodec.plan, telemetry.correct_stats
    queue, stat_queue = iter(inject or []), iter(inject_stats or [])

    def plan(self, cfg, flat, stat):
        if inject is not None:
            lv, a = next(queue)
            return QuantMeta(levels=torch.from_numpy(lv), alpha=torch.tensor(a))
        meta = orig(self, cfg, flat, stat)
        plans.append((meta.levels.numpy().copy(), meta.alpha.numpy().copy()))
        return meta

    def injected_stats(g, e=None):
        c, _ = correct_stats(g, e)
        return c, tuple(torch.from_numpy(x) for x in next(stat_queue))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codecs.QuantizerCodec, "plan", plan)
        if inject_stats is not None:
            mp.setattr(telemetry, "correct_stats", injected_stats)
        mean, resid, _, cm = reference_sync_state(
            ts, [torch.from_numpy(x) for x in leaves], dp, prng.fold_in(prng.key(0x5EED), 0),
            ef=None if ef is None else [torch.from_numpy(e) for e in ef],
            live=None if live is None else torch.tensor(live))
    if inject is not None:
        assert next(queue, None) is None, "the port made fewer plans than JAX"
    if inject_stats is not None:
        assert next(stat_queue, None) is None, "the port computed fewer statistics than JAX"
    assert isinstance(cm, metrics.CompressionMetrics)
    return ([m.numpy() for m in mean], None if resid is None else [r.numpy() for r in resid],
            {f: v.numpy() for f, v in zip(cm._fields, cm)}, plans)


@pytest.fixture(scope="module", params=list(CASES.values()), ids=list(CASES))
def runs(request):
    ref = _run_jax(*request.param)
    return (request.param, ref, _run_port(*request.param, inject=ref[3], inject_stats=ref[4]),
            _run_port(*request.param))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def test_geometry_exact(runs):
    (_, _, _, _, fp16, _), (_, _, jcm, *_), (_, _, cm, _), _ = runs
    for f in jcm:
        assert cm[f].shape == jcm[f].shape == (N, 2) and cm[f].dtype == jcm[f].dtype, f
    for f in EXACT:
        assert np.array_equal(cm[f], jcm[f]), f
    if fp16:
        assert (cm["bits"][:, 0] == 16).all() and (cm["bits"][:, 1] == 3).all()


def test_injected_plans_and_statistics(runs):
    (sync, _, method, ef_on, _, live), (jmean, jresid, jcm, *_), (mean, resid, cm, _), _ = runs
    for f in ("alpha", "clip_frac"):
        assert (_bits(cm[f]) == _bits(jcm[f])).all(), f
    for f, rtol in (("realized_mse", SUM_RTOL), ("ef_norm", SUM_RTOL),
                    ("predicted_mse", PRED_RTOL)):
        np.testing.assert_allclose(cm[f], jcm[f], rtol=rtol, atol=0, err_msg=f)
    if live is not None and sync != "dsgd":
        # a dropped peer's realized error is its whole corrected bucket's
        leaves, ef = _inputs(method, ef_on)
        bp = plan_buckets([int(np.prod(s)) for s in SHAPES],
                          TrainStepConfig(bucket_mb=BUCKET_MB).bucket_elements)
        for b, g in enumerate(bucket_concat([torch.from_numpy(x[1]) for x in leaves], bp)):
            c = g if ef is None else g + torch.from_numpy(ef[b][1, :g.numel()])
            want = metrics._sum_sq(c) / torch.tensor(float(g.numel()))
            assert cm["realized_mse"][1, b] == want.numpy(), b
    if method in ("powersgd", "tqsgd", "qsgd"):
        rtol, atol = (LOWRANK_RTOL, LOWRANK_ATOL) if method == "powersgd" else (0, UNIFORM_ATOL)
        for g, w in zip(mean + (resid or []), jmean + (jresid or [])):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * float(np.abs(w).max()))
        return
    for g, w in zip(mean, jmean):
        assert (_bits(g) == _bits(w)).all()
    if ef_on:
        for g, w in zip(resid, jresid):
            assert (_bits(g) == _bits(w)).all()


def test_end_to_end_within_rounding(runs):
    _, (_, _, jcm, jplans, _), _, (_, _, cm, plans) = runs
    assert len(plans) == len(jplans)
    for (_, a), (_, ja) in zip(plans, jplans):
        np.testing.assert_allclose(a, ja, rtol=PLAN_RTOL)
    np.testing.assert_allclose(cm["alpha"], jcm["alpha"], rtol=PLAN_RTOL, atol=0)
    np.testing.assert_allclose(cm["predicted_mse"], jcm["predicted_mse"], rtol=E2E_PRED_RTOL,
                               atol=0)
    # a moved level moves the clipped count by an element or so and the
    # realized error by about the levels' own relative difference
    np.testing.assert_allclose(cm["clip_frac"], jcm["clip_frac"], rtol=0, atol=2 / min(SIZES))
    np.testing.assert_allclose(cm["realized_mse"], jcm["realized_mse"], rtol=PLAN_RTOL, atol=0)
    np.testing.assert_allclose(cm["ef_norm"], jcm["ef_norm"], rtol=SUM_RTOL, atol=0)


def test_qsgd_realized_tracks_predicted():
    """Gaussian gradients, qsgd at 4 bits: the realized MSE is within a
    small factor of the predicted E_TQ."""
    ts = TrainStepConfig(sync="faithful", bucket_mb=1.0 / 64.0, error_feedback=True,
                         metrics_compression=True,
                         compressor=CompressorConfig(method="qsgd", bits=4))
    rng = np.random.default_rng(7)
    leaves = [torch.from_numpy((0.1 * rng.standard_normal((2, 4096))).astype(np.float32))
              for _ in range(2)]
    _, _, _, cm = reference_sync_state(ts, leaves, (2,), prng.key(3))
    realized, predicted = cm.realized_mse.numpy(), cm.predicted_mse.numpy()
    assert (realized >= 0.0).all() and (predicted > 0.0).all()
    ratio = realized / predicted
    assert ((ratio > 0.2) & (ratio < 5.0)).all(), ratio


def test_tree_sum_adds_in_pairs():
    # (2^24 + 1) + (1 + 1) = 2^24 + 2, where adding 1 at a time stays at 2^24
    x = torch.tensor([2.0 ** 24, 1.0, 1.0, 1.0], dtype=torch.float32)
    assert float(metrics._tree_sum(x)) == 2.0 ** 24 + 2
    # five values: ((2^24 + 1) + (1 + 1)) + (1 + 0) = 2^24 + 3, rounded to even
    assert float(metrics._tree_sum(torch.cat([x, torch.ones(1)]))) == 2.0 ** 24 + 4
    assert float(metrics._tree_sum(x[:0])) == 0.0
    assert float(metrics._tree_sum(x[:1])) == 2.0 ** 24
