"""The port's wire accounting (``dist.collectives``), collective budgets
and fp16 small-bucket tier against the JAX package, on the CPU.

- Every byte count of ``wire_bytes_per_device``, ``decode_hbm_bytes`` and
  ``encode_hbm_bytes`` equals JAX's, over methods, sync modes, per-bucket
  plans (bit widths, ``("powersgd", rank)`` and ``("fp16", bits)``
  entries), peer counts and live counts, fused or not.
- The fp16 codec's wire words are JAX's bit for bit (two float16 values a
  word, the even element in the low half; odd lengths, infinities, NaN,
  subnormals and overflow included), and so are its decodes and residuals.
- One bucketed replay step with ``fp16_threshold``: buckets of 600 and 33
  elements ship float16, the 1,500-element one tnqsgd at 3 bits, error
  feedback on, faithful over 3 peers and two_phase over (4,).  With JAX's
  plans injected the mean leaves and EF rows are bitwise JAX's
  ``reference_sync_state`` (which runs eagerly, its plans under
  ``jax.jit``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.compressors import CompressorConfig as JConfig  # noqa: E402
from repro.core.compressors import plan_from_stats as jplan_from_stats  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.dist.reference import reference_sync_state as jsync  # noqa: E402
from repro.dist.train_step import TrainStepConfig as JTS  # noqa: E402
from repro_torch.core import codecs, prng  # noqa: E402
from repro_torch.core.compressors import CompressorConfig  # noqa: E402
from repro_torch.core.quantizers import QuantMeta  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.dist.reference import reference_sync_state  # noqa: E402
from repro_torch.dist.train_step import TrainStepConfig  # noqa: E402

METHODS = ("dsgd", "qsgd", "tqsgd", "tnqsgd", "powersgd", "fp16")
SIZES = [10, 4097, 206_922]
BUCKETS = [4928, 200_704, 1290]
PLANS = [None, 2, [3, 2, 8], [3, ("powersgd", 4), 2], [("fp16", 3), 4, ("powersgd", 2)]]


def _cfgs(method, **kw):
    return CompressorConfig(method=method, **kw), JConfig(method=method, **kw)


@pytest.mark.parametrize("method", METHODS)
def test_byte_counts_match_jax(method):
    for kw in ({}, {"bits": 8, "rank": 2}, {"approx_gmin": True, "plan_sample": 1000}):
        cfg, jcfg = _cfgs(method, **kw)
        for shards in (1, 3, 8):
            for live in (None, 1, shards):
                for n in SIZES:
                    for mode in collectives.MODES:
                        assert collectives.wire_bytes_per_device(cfg, n, shards, mode, live=live) \
                            == jcoll.wire_bytes_per_device(jcfg, n, shards, mode, live=live)
                    for fused in (False, True):
                        assert collectives.decode_hbm_bytes(cfg, n, shards, fused, live=live) \
                            == jcoll.decode_hbm_bytes(jcfg, n, shards, fused, live=live)
        for n in SIZES + [BUCKETS]:
            for fused in (False, True):
                for ef in (False, True):
                    for adaptive in (False, True):
                        assert collectives.encode_hbm_bytes(cfg, n, fused, ef=ef, adaptive=adaptive) \
                            == jcoll.encode_hbm_bytes(jcfg, n, fused, ef=ef, adaptive=adaptive)
    if method in ("dsgd", "fp16"):
        return
    cfg, jcfg = _cfgs(method)
    for plan in PLANS:
        for mode in collectives.MODES:
            assert collectives.wire_bytes_per_device(cfg, BUCKETS, 8, mode, plan) == \
                jcoll.wire_bytes_per_device(jcfg, BUCKETS, 8, mode, plan)
        for fused in (False, True):
            assert collectives.decode_hbm_bytes(cfg, BUCKETS, 8, fused, plan, live=5) == \
                jcoll.decode_hbm_bytes(jcfg, BUCKETS, 8, fused, plan, live=5)
            assert collectives.encode_hbm_bytes(cfg, BUCKETS, fused, bits=plan) == \
                jcoll.encode_hbm_bytes(jcfg, BUCKETS, fused, bits=plan)


def test_accounting_rejects_what_jax_rejects():
    cfg = CompressorConfig()
    for bad in (lambda: collectives.wire_bytes_per_device(cfg, 10, 4, "ring"),
                lambda: collectives.wire_bytes_per_device(cfg, 10, 0, "faithful"),
                lambda: collectives.wire_bytes_per_device(cfg, 10, 4, "faithful", live=5),
                lambda: collectives.decode_hbm_bytes(cfg, [10, 20], 4, True, [3]),
                lambda: collectives.encode_hbm_bytes(cfg, [10, 20], True, bits=[3])):
        with pytest.raises(ValueError):
            bad()


def test_budgets_and_size_adaptive_plan_match_jax():
    assert codecs.COLLECTIVE_BUDGETS == jcodecs.COLLECTIVE_BUDGETS
    for method in METHODS:
        for mode in ("dsgd", "faithful", "two_phase", "hierarchical"):
            assert codecs.get_codec(method).collective_budget(mode, 3) == \
                jcodecs.get_codec(method).collective_budget(mode, 3)
        if method != "dsgd":     # dsgd's budget is its bucket count in every mode
            with pytest.raises(ValueError, match="unknown sync mode"):
                codecs.get_codec(method).collective_budget("ring")
    cfg, jcfg = _cfgs("tnqsgd")
    for plan in (None, (3, ("powersgd", 4), 2)):
        for threshold in (0, 1290, 5000, 10**6):
            got = codecs.size_adaptive_plan(cfg, plan, BUCKETS, threshold)
            want = jcodecs.size_adaptive_plan(jcfg, plan, BUCKETS, threshold)
            assert [c if isinstance(c, tuple | int | type(None)) else c.method
                    for c in (got or [None])] == \
                [c if isinstance(c, tuple | int | type(None)) else c.method
                 for c in (want or [None])]
    with pytest.raises(ValueError, match="entries"):
        codecs.size_adaptive_plan(cfg, (3, 2), BUCKETS, 5000)
    fp16, jfp16 = codecs.get_codec("fp16"), jcodecs.get_codec("fp16")
    for n in (1, 2, 33, 600):
        for chunks in (1, 3, 4):
            assert fp16.chunk_elems(cfg, n, chunks) == jfp16.chunk_elems(jcfg, n, chunks)
            assert fp16.chunk_wire_words(cfg, n, chunks) == jfp16.chunk_wire_words(jcfg, n, chunks)
        assert fp16.wire_words(cfg, n) == jfp16.wire_words(jcfg, n)
        assert fp16.wire_bytes(cfg, n) == jfp16.wire_bytes(jcfg, n)


def _u32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _same(got, want) -> bool:
    """Bitwise equal float32, NaN for NaN whatever its payload (inf − inf
    is a NaN whose sign the two packages' arithmetic may set apart)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    return bool((np.isnan(got) == nan).all() and (_u32(got)[~nan] == _u32(want)[~nan]).all())


@pytest.mark.parametrize("n", [1, 2, 7, 600])
def test_fp16_wire_bitwise(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(3 * rng.standard_normal(n))).astype(np.float32)
    x[: min(n, 6)] = np.array([np.inf, -np.inf, np.nan, 1e-7, 7e4, -0.0], np.float32)[: min(n, 6)]
    cfg, jcfg = _cfgs("fp16")
    codec, jcodec = codecs.get_codec("fp16"), jcodecs.get_codec("fp16")
    wire, resid, aux = codec.encode_residual(cfg, torch.from_numpy(x), None, None)
    jwire, jresid, _ = jcodec.encode_residual(jcfg, jnp.asarray(x), None, None, False)
    assert aux is None and wire.dtype == torch.int32
    assert (_u32(wire.numpy()) == np.array(jwire)).all()
    assert _same(resid.numpy(), jresid)
    rows = torch.stack([wire, wire.flip(0)])
    jrows = jnp.stack([jwire, jnp.flip(jwire, 0)])
    assert _same(codec.decode_rows(cfg, rows, n).numpy(), jcodec.decode_rows(jcfg, jrows, n, False))
    assert _same(codec.decode_reduce(cfg, rows, n).numpy(),
                 jcodec.decode_reduce(jcfg, jrows, n, False))
    for chunks in (1, 3):
        w, r = codec.encode_chunks(cfg, torch.from_numpy(x), None, None, chunks)
        jw, jr = jcodec.encode_chunks(jcfg, jnp.asarray(x), None, None, chunks, False)
        assert (_u32(w.numpy()) == np.array(jw)).all() and _same(r.numpy(), jr)


SHAPES, SCALES = [(600,), (30, 50), (3, 11)], [1e-2, 1e-3, 3e-4]
_jit_plan = jax.jit(jplan_from_stats, static_argnums=0)


def _leaves(peers):
    rng = np.random.default_rng(11)
    return [(s * rng.standard_normal((peers, *shape)) * np.exp(rng.standard_normal((peers, *shape))))
            .astype(np.float32) for shape, s in zip(SHAPES, SCALES)]


@pytest.mark.parametrize("sync,dp", [("faithful", (3,)), ("two_phase", (4,))])
def test_fp16_tier_replay_matches_jax(sync, dp):
    peers = int(np.prod(dp))
    kw = dict(sync=sync, error_feedback=True, bucket_mb=0.0005, fp16_threshold=700)
    jts = JTS(compressor=JConfig(method="tnqsgd", bits=3), **kw)
    ts = TrainStepConfig(compressor=CompressorConfig(method="tnqsgd", bits=3), **kw)
    leaves = _leaves(peers)
    rng = np.random.default_rng(12)
    ef = [(1e-4 * rng.standard_normal((peers, m))).astype(np.float32) for m in (600, 1500, 33)]
    plans = []

    def recording(self, cfg, flat, stat, use_pallas):
        if stat is None:
            stat = jcodecs._bucket_stats(flat, use_pallas)
        meta = _jit_plan(cfg, stat[0], stat[1], stat[2])
        plans.append((np.array(meta.levels), np.array(meta.alpha)))
        return meta

    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)   # the port's layout
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcodecs.QuantizerCodec, "plan", recording)
            jmean, jef, _, _ = jsync(jts, [jnp.asarray(x) for x in leaves], dp,
                                     jax.random.key(9), ef=[jnp.asarray(e) for e in ef])
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    queue = iter(plans)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codecs.QuantizerCodec, "plan", lambda self, cfg, flat, stat: QuantMeta(
            *(torch.from_numpy(np.asarray(v)) for v in next(queue))))
        mean, ef2, _, _ = reference_sync_state(ts, [torch.from_numpy(x) for x in leaves], dp,
                                               prng.key(9), ef=[torch.from_numpy(e) for e in ef])
    assert next(queue, None) is None and len(plans) == (peers if sync == "faithful" else 2 * peers)
    for got, want in zip(mean, jmean):
        assert got.shape == want.shape and (_u32(got.numpy()) == _u32(np.array(want))).all()
    for got, want in zip(ef2, jef):
        assert (_u32(got.numpy()) == _u32(np.array(want))).all()
