"""The port's PowerSGD codec (``repro_torch.core.lowrank``) and the plain
version of its Gram–Schmidt kernel K11 against the JAX package, on
identical numpy inputs, on the CPU.

Contract:
- ``ops.orthogonalize`` (on the CPU: ``kernels.ref.orthogonalize``) within
  rtol 1e-5 / atol 1e-6 of both JAX versions — ``kernels.ref`` and the
  Pallas kernel in interpret mode — at ``tests/test_lowrank.py``'s shapes,
  the JAX package's own kernel-vs-oracle contract; zero columns exactly
  zero; a rank-deficient factor compared by its reconstruction P̂P̂ᵀp and
  by P̂ᵀP̂ ≈ I, since its surplus columns are normalized rounding noise that
  differs between any two implementations;
- the geometry (``matrix_shape``, ``effective_rank``, wire and state
  sizes, ``wire_bytes``) and the plan-entry resolution equal JAX's exactly;
- the codec's P̂, Qn, residual, new aux and decodes within rtol 1e-5 and
  atol 1e-6 × the largest magnitude: the cold-start Q₀ is a few ulp from
  ``jax.random.normal`` (``prng.normal``) and the products reduce in
  another order than XLA's (largest difference measured on these inputs:
  3.5e-7 of the largest magnitude).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import compressors as jcomp  # noqa: E402
from repro.core import lowrank as jlowrank  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import codecs, compressors, lowrank  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(8, 4), (128, 8), (1000, 3), (7, 7), (513, 16)]
SIZES = [1, 2, 3, 31, 32, 999, 2257, 3072, 206_922, 1 << 20]
RANKS = [1, 4, 64]
RTOL, ATOL = 1e-5, 1e-6
# compiled once per shape: eager, every op of the unrolled loop compiles anew
_jref_orth = jax.jit(jref.orthogonalize)


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_orthogonalize_matches_both_jax_versions(shape):
    p = np.random.default_rng(shape[0] * 100 + shape[1]).standard_normal(shape).astype(np.float32)
    got = ops.orthogonalize(torch.from_numpy(p)).numpy()
    for want in (_jref_orth(jnp.asarray(p)),
                 jops.orthogonalize(jnp.asarray(p), interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_orthogonalize_zero_columns_stay_zero():
    p = torch.zeros((64, 4))
    p[:, 0] = 1.0
    q = ops.orthogonalize(p)
    assert bool(torch.isfinite(q).all())
    assert bool((q[:, 1:] == 0).all())
    np.testing.assert_allclose(q.numpy(), np.asarray(_jref_orth(jnp.asarray(p.numpy()))),
                               rtol=RTOL, atol=ATOL)


def test_orthogonalize_rank_deficient_by_reconstruction():
    p = np.random.default_rng(5).standard_normal((809, 4)).astype(np.float32)
    p[:, 2] = 0.5 * p[:, 0] + 2.0 * p[:, 1]
    p[:, 3] = p[:, 1]
    got = ops.orthogonalize(torch.from_numpy(p)).numpy()
    want = np.asarray(_jref_orth(jnp.asarray(p)))
    scale = float(np.abs(p).max())
    for q in (got, want):
        np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)
        np.testing.assert_allclose(q @ (q.T @ p), p, atol=1e-5 * scale)
    np.testing.assert_allclose(got @ (got.T @ p), want @ (want.T @ p), atol=1e-5 * scale)
    # the two independent columns are the same basis in both
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=RTOL, atol=ATOL)


def test_geometry_equals_jax():
    jcodec, codec = jcodecs.get_codec("powersgd"), codecs.get_codec("powersgd")
    for m in SIZES:
        assert lowrank.matrix_shape(m) == jlowrank.matrix_shape(m), m
        for rank in RANKS:
            jcfg = jcomp.CompressorConfig(method="powersgd", rank=rank)
            cfg = compressors.CompressorConfig(method="powersgd", rank=rank)
            assert lowrank.effective_rank(cfg, m) == jlowrank.effective_rank(jcfg, m)
            assert codec.wire_words(cfg, m) == jcodec.wire_words(jcfg, m)
            assert codec.state_extra(cfg, m) == jcodec.state_extra(jcfg, m)
            assert codec.wire_bytes(cfg, m) == jcodec.wire_bytes(jcfg, m)
            assert compressors.wire_bytes(cfg, m) == jcomp.wire_bytes(jcfg, m)
    for rank in RANKS:
        plan = (3, ("powersgd", rank), 2)
        jbase, base = jcomp.CompressorConfig(bits=4), compressors.CompressorConfig(bits=4)
        assert (codecs.bucket_state_sizes(base, SIZES[5:8], plan)
                == jcodecs.bucket_state_sizes(jbase, SIZES[5:8], plan))
        jcfg = jcomp.CompressorConfig(method="powersgd", rank=rank)
        cfg = compressors.CompressorConfig(method="powersgd", rank=rank)
        assert codecs.bucket_state_sizes(cfg, SIZES) == jcodecs.bucket_state_sizes(jcfg, SIZES)


def _entries(mod):
    return [5, ("tqsgd", 3), ("powersgd", 2), ("tnqsgd", 3),
            mod.CompressorConfig(method="powersgd", bits=2, rank=8)]


def test_plan_entries_and_wire_bytes_equal_jax():
    jbase = jcomp.CompressorConfig(method="tnqsgd", bits=3)
    base = compressors.CompressorConfig(method="tnqsgd", bits=3)
    for jentry, entry in zip(_entries(jcomp), _entries(compressors)):
        jcfg, cfg = jcodecs.bucket_cfg_entry(jbase, jentry), codecs.bucket_cfg_entry(base, entry)
        assert (cfg.method, cfg.bits, cfg.rank) == (jcfg.method, jcfg.bits, jcfg.rank), entry
        for m in SIZES:
            assert compressors.wire_bytes(base, m, entry) == jcomp.wire_bytes(jbase, m, jentry)
    pw = codecs.bucket_cfg_entry(base, ("powersgd", 2))
    assert (pw.method, pw.rank, pw.bits) == ("powersgd", 2, 3)
    assert codecs.bucket_cfg_entry(base, ("tnqsgd", 3)) is base
    assert (compressors.wire_bytes(base, [999, 2257, 3072], [3, ("powersgd", 2), 2])
            == jcomp.wire_bytes(jbase, [999, 2257, 3072], [3, ("powersgd", 2), 2]))
    for bad in (("powersgd",), ("powersgd", 2, 3), (2, 3), ("powersgd", "two"), "three"):
        with pytest.raises(ValueError):
            codecs.bucket_cfg_entry(base, bad)
        with pytest.raises(ValueError):
            jcodecs.bucket_cfg_entry(jbase, bad)


def test_registry_and_config_accept_powersgd():
    assert "powersgd" in codecs.known_methods()
    codec = codecs.get_codec("powersgd")
    assert codec.rank_based and not codec.chunkable
    assert not codecs.get_codec("tnqsgd").rank_based
    with pytest.raises(ValueError, match="already registered"):
        codecs.register_codec(lowrank.PowerSGDCodec())
    assert "fp16" in codecs.known_methods()
    assert compressors.CompressorConfig(method="fp16").method == "fp16"
    with pytest.raises(ValueError, match="unknown method"):
        compressors.CompressorConfig(method="nosuch")


@pytest.mark.parametrize("m", [2257, 3000])
def test_codec_matches_jax(m):
    """encode_residual cold and warm, then the decodes of JAX's own wires."""
    rng = np.random.default_rng(m)
    rows, cols = lowrank.matrix_shape(m)
    jcfg = jcomp.CompressorConfig(method="powersgd", rank=4)
    cfg = compressors.CompressorConfig(method="powersgd", rank=4)
    jcodec, codec = jcodecs.get_codec("powersgd"), codecs.get_codec("powersgd")
    jencode = jax.jit(lambda flat, aux: jcodec.encode_residual(jcfg, flat, None, None, False,
                                                               aux=aux))
    pw = rows * 4
    jwires = []
    for warm in (False, True):
        flat = (1e-3 * rng.standard_normal(m) * np.exp(rng.standard_normal(m))).astype(np.float32)
        aux = rng.standard_normal(cols * 4).astype(np.float32) if warm else None
        jw, jr, ja = jencode(jnp.asarray(flat), None if aux is None else jnp.asarray(aux))
        w, r, a = codec.encode_residual(cfg, torch.from_numpy(flat), None, None,
                                        aux=None if aux is None else torch.from_numpy(aux))
        jwf, wf = np.asarray(jw).view(np.float32), w.numpy().view(np.float32)
        assert w.dtype == torch.int32 and wf.shape == jwf.shape == (codec.wire_words(cfg, m),)
        _close(wf[:pw], jwf[:pw], f"P̂ warm={warm}")
        _close(wf[pw:], jwf[pw:], f"Qn warm={warm}")
        _close(r, jr, f"residual warm={warm}")
        _close(a, ja, f"aux warm={warm}")
        jwires.append(np.asarray(jw))
    jrows = np.stack(jwires)
    rows_t = torch.from_numpy(jrows.view(np.int32))
    _close(codec.decode_reduce(cfg, rows_t, m), jcodec.decode_reduce(jcfg, jnp.asarray(jrows), m,
                                                                     False), "decode_reduce")
    _close(codec.decode_rows(cfg, rows_t, m), jcodec.decode_rows(jcfg, jnp.asarray(jrows), m,
                                                                 False), "decode_rows")
