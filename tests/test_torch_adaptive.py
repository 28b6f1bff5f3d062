"""The port's adaptive telemetry and bit allocator (``adaptive.telemetry``,
``adaptive.controller``) against the JAX package, on the CPU.

- Telemetry: three EMA updates of two buckets over 3 peers, then the
  peers merged and the tails and densities estimated.  Given the same
  statistics the EMA state is JAX's bit for bit; from its own statistics
  pass the counts and maxima are exact and the ln and moment sums within
  rtol 1e-5 (they are added in another order, ROADMAP fact F5), and the
  tails, fitted from those sums, within F3's rtol 1e-4.  The densities sit
  on the statistics' bin edges, which the two packages round apart
  (fact F7), and agree to rtol 1e-5.
- Allocator: on the same tails and densities (JAX's estimates, handed to
  both), ``budget_bytes``, ``allocate_bits`` and ``allocate_plan`` give the
  same plans and byte counts, and the predicted errors agree to rtol 1e-5
  (the fixed-point α and the error model are float32 in both packages and
  round a few operations differently).  The tails are spread over two
  decades of scale and three of tail index, so no two upgrades tie: the
  best score beats the runner-up by far more than that rounding.
- ``AdaptiveConfig`` and ``TrainStepConfig(adaptive=...)`` reject what the
  JAX package rejects.
- ``reference_sync_state(tstate=...)``: two faithful steps over 3 peers
  with error feedback, JAX's plans injected: the mean leaves are bitwise
  JAX's and the telemetry as above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.adaptive import controller as jctl  # noqa: E402
from repro.adaptive import telemetry as jtel  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.core.compressors import plan_from_stats as jplan_from_stats  # noqa: E402
from repro.core.distributions import PowerLawTail as JTail  # noqa: E402
from repro.dist.reference import reference_sync_state as jsync  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro_torch.adaptive import controller, telemetry  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.distributions import EmpiricalDensity, PowerLawTail  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist.reference import reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402

PEERS, SIZES, STEPS = 3, (600, 1500), 3
SUM_RTOL, TAIL_RTOL, ERR_RTOL = 1e-5, 1e-4, 1e-5
# the bin edges 2^(−24 + k/4): XLA's float32 exp2 lands up to 5.4e-7
# (relative) off the powers of two that torch's gives (ROADMAP fact F7), and
# a density divides each count by its bin's width (an edge difference)
EDGE_RTOL, DENS_RTOL = 1e-6, 1e-5
EXACT = ("counts", "g_max", "steps")


def _bucket_rows(step: int) -> list[np.ndarray]:
    rng = np.random.default_rng(50 + step)
    return [(s * rng.standard_normal((PEERS, m)) * np.exp(rng.standard_normal((PEERS, m))))
            .astype(np.float32) for m, s in zip(SIZES, (1e-2, 3e-4))]


def _assert_state(got, want, exact=False):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.array(getattr(want, f))
        if exact or f in EXACT:
            assert a.shape == b.shape and (a.view(np.uint32) == b.view(np.uint32)).all(), f
        else:
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=SUM_RTOL * np.abs(b).max(),
                                       err_msg=f)


@pytest.mark.parametrize("given_stats", [True, False], ids=["same_stats", "own_stats"])
def test_telemetry_matches_jax(given_stats):
    rows = [telemetry.init_telemetry(len(SIZES))] * PEERS
    jrows = [jtel.init_telemetry(len(SIZES))] * PEERS
    for step in range(STEPS):
        buckets = _bucket_rows(step)
        for p in range(PEERS):
            jb = [jnp.asarray(b[p]) for b in buckets]
            jstats = [jtel.bucket_statistics(g) for g in jb]
            jrows[p] = jtel.update_telemetry(jrows[p], jb, decay=0.8, stats=jstats)
            stats = ([tuple(torch.from_numpy(np.array(x)) for x in st) for st in jstats]
                     if given_stats else None)
            rows[p] = telemetry.update_telemetry(rows[p], [torch.from_numpy(b[p]) for b in buckets],
                                                 decay=0.8, stats=stats)
    state = telemetry.stack_rows(rows)
    jstate = jax.tree.map(lambda *xs: jnp.stack(xs), *jrows)
    _assert_state(state, jstate, exact=given_stats)
    agg, jagg = telemetry.aggregate_peers(state), jtel.aggregate_peers(jstate)
    _assert_state(agg, jagg, exact=given_stats)
    for got, want in zip(telemetry.estimate_tails(agg, gmin_quantile=0.8),
                         jtel.estimate_tails(jagg, gmin_quantile=0.8)):
        np.testing.assert_allclose(got.numpy(), np.array(want), rtol=TAIL_RTOL)
    for got, want in zip(telemetry.estimate_densities(agg), jtel.estimate_densities(jagg)):
        np.testing.assert_allclose(got.edges.numpy(), np.array(want.edges), rtol=EDGE_RTOL)
        np.testing.assert_allclose(got.density.numpy(), np.array(want.density), rtol=DENS_RTOL)
    with pytest.raises(ValueError, match="buckets"):
        telemetry.update_telemetry(rows[0], [torch.zeros(3)])


# (gamma, g_min, rho, g_max) per bucket: scales over two decades, tail
# indices over [3.1, 4.8], sizes from 1,290 to 200,704
TAILS = [(3.1, 2e-3, 0.05, 0.3), (4.8, 1e-4, 0.1, 2e-3), (3.6, 5e-4, 0.02, 0.05),
         (4.2, 3e-3, 0.08, 0.1)]
ALLOC_SIZES = [4928, 200_704, 1290, 25_088]


def _alloc_inputs():
    rng = np.random.default_rng(3)
    edges = np.array(jtel.kstats.bin_edges())
    tails, jtails, dens, jdens = [], [], [], []
    for gamma, g_min, rho, g_max in TAILS:
        vals = [np.float32(v) for v in (gamma, g_min, rho, g_max)]
        tails.append(PowerLawTail(*(torch.tensor(v) for v in vals)))
        jtails.append(JTail(*(jnp.asarray(v) for v in vals)))
        g = (g_min * rng.standard_normal(20_000) * np.exp(rng.standard_normal(20_000)))
        counts = np.histogram(np.abs(g), bins=edges)[0].astype(np.float32)
        jd = jtel.density_from_histogram(jnp.asarray(counts), jnp.asarray(edges))
        jdens.append(jd)
        dens.append(EmpiricalDensity(edges=torch.from_numpy(edges),
                                     density=torch.from_numpy(np.array(jd.density))))
    return tails, jtails, dens, jdens


# (method, densities handed in, min_bits, max_bits): the non-uniform model
# with its densities (and allocate_plan's powersgd trades), the uniform one
# without, and the untruncated α = max|g|
ALLOC_CASES = [("tnqsgd", True, 2, 8), ("tqsgd", False, 1, 4), ("qsgd", True, 2, 8)]


@pytest.mark.parametrize("method,with_dens,lo,hi", ALLOC_CASES)
def test_allocator_matches_jax(method, with_dens, lo, hi):
    tails, jtails, dens, jdens = _alloc_inputs()
    d, jd = (dens, jdens) if with_dens else (None, None)
    ccfg, jccfg = CompressorConfig(method=method, bits=3), JConfig(method=method, bits=3)
    for wire_mb in (0.0, 0.05):
        acfg = controller.AdaptiveConfig(wire_budget_mb=wire_mb)
        jacfg = jctl.AdaptiveConfig(wire_budget_mb=wire_mb)
        for live in (1.0, 0.5):
            assert controller.budget_bytes(acfg, ccfg, ALLOC_SIZES, live) == \
                jctl.budget_bytes(jacfg, jccfg, ALLOC_SIZES, live)
    budget = controller.budget_bytes(controller.AdaptiveConfig(), ccfg, ALLOC_SIZES)
    stacked = PowerLawTail(*(torch.stack(fs) for fs in zip(*tails)))
    got = controller.allocate_bits(stacked, ALLOC_SIZES, budget, ccfg, dens=d, min_bits=lo,
                                   max_bits=hi)
    want = jctl.allocate_bits(jtails, ALLOC_SIZES, budget, jccfg, dens=jd, min_bits=lo,
                              max_bits=hi)
    assert (got.bits, got.spend_bytes, got.budget_bytes) == \
        (want.bits, want.spend_bytes, want.budget_bytes)
    assert len(set(got.bits)) > 1      # the budget is redistributed, not spread evenly
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=ERR_RTOL)
    np.testing.assert_allclose(got.err, want.err, rtol=ERR_RTOL)
    np.testing.assert_allclose(
        controller.predicted_error(tails, ALLOC_SIZES, got.bits, ccfg, dens=d),
        jctl.predicted_error(jtails, ALLOC_SIZES, want.bits, jccfg, dens=jd), rtol=ERR_RTOL)
    if with_dens and method == "tnqsgd":
        got = controller.allocate_plan(tails, ALLOC_SIZES, budget, ccfg, dens=d)
        want = jctl.allocate_plan(jtails, ALLOC_SIZES, budget, jccfg, dens=jd)
        assert (got.entries, got.spend_bytes, got.budget_bytes) == \
            (want.entries, want.spend_bytes, want.budget_bytes)
        np.testing.assert_allclose(got.alphas, want.alphas, rtol=ERR_RTOL)
        np.testing.assert_allclose(got.err, want.err, rtol=ERR_RTOL)
    with pytest.raises(ValueError, match="tails"):
        controller.allocate_bits(tails[:2], ALLOC_SIZES, budget, ccfg)


def test_configs_reject_what_jax_rejects():
    bad = [dict(min_bits=0), dict(min_bits=5, max_bits=4), dict(max_bits=9), dict(replan_every=0),
           dict(ema=0.0), dict(ema=1.0), dict(switch_threshold=-0.1), dict(max_cached_steps=0),
           dict(live_hysteresis=1.0), dict(live_hysteresis=-0.5)]
    for kw in bad:
        with pytest.raises(ValueError) as err:
            controller.AdaptiveConfig(**kw)
        with pytest.raises(ValueError) as jerr:
            jctl.AdaptiveConfig(**kw)
        assert str(err.value) == str(jerr.value)
    assert dataclass_fields(controller.AdaptiveConfig) == dataclass_fields(jctl.AdaptiveConfig)
    for kw in (dict(sync="dsgd"), dict(sync="faithful", bucket_mb=0),
               dict(sync="faithful", compressor="dsgd")):
        method = kw.pop("compressor", "tnqsgd")
        with pytest.raises(ValueError) as err:
            TrainStepConfig(adaptive=controller.AdaptiveConfig(),
                            compressor=CompressorConfig(method=method), **kw)
        with pytest.raises(ValueError) as jerr:
            JTS(adaptive=jctl.AdaptiveConfig(), compressor=JConfig(method=method), **kw)
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="live_frac"):
        controller.budget_bytes(controller.AdaptiveConfig(), CompressorConfig(), [10], 0.0)


def dataclass_fields(cls) -> list:
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


_jit_plan = jax.jit(jplan_from_stats, static_argnums=0)


def test_reference_sync_state_telemetry_matches_jax():
    kw = dict(sync="faithful", error_feedback=True, bucket_mb=0.0005)
    jts = JTS(compressor=JConfig(method="tnqsgd", bits=3), adaptive=jctl.AdaptiveConfig(ema=0.8),
              **kw)
    ts = TrainStepConfig(compressor=CompressorConfig(method="tnqsgd", bits=3),
                         adaptive=controller.AdaptiveConfig(ema=0.8), **kw)
    plans = []

    def recording(self, cfg, flat, stat, use_pallas):
        meta = _jit_plan(cfg, stat[0], stat[1], stat[2])
        plans.append((np.array(meta.levels), np.array(meta.alpha)))
        return meta

    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    jt = jax.tree.map(lambda *xs: jnp.stack(xs), *[jtel.init_telemetry(2)] * PEERS)
    t = telemetry.stack_rows([telemetry.init_telemetry(2)] * PEERS)
    jef = ef = None
    try:
        for step in range(2):
            leaves = _bucket_rows(step)
            plans.clear()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
                jmean, jef, jt, _ = jsync(jts, [jnp.asarray(x) for x in leaves], (PEERS,),
                                          jax.random.fold_in(jax.random.key(1), step), ef=jef,
                                          tstate=jt)
            queue = iter(plans)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(codecs.QuantizerCodec, "plan", lambda self, cfg, flat, stat: QuantMeta(
                    *(torch.from_numpy(np.asarray(v)) for v in next(queue))))
                mean, ef, t, _ = reference_sync_state(
                    ts, [torch.from_numpy(x) for x in leaves], (PEERS,),
                    prng.fold_in(prng.key(1), step), ef=ef, tstate=t)
            for got, want in zip(mean, jmean):
                assert (got.numpy().view(np.uint32) == np.array(want).view(np.uint32)).all()
            _assert_state(t, jt)
            # the next step starts from the same telemetry and residuals
            t = telemetry.TelemetryState(*(torch.from_numpy(np.array(x)) for x in jt))
            ef = [torch.from_numpy(np.array(e)) for e in jef]
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    assert float(t.steps[0]) == 2.0
