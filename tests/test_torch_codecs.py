"""The port's quantizer codec (``repro_torch.core.codecs.QuantizerCodec``)
against the JAX package's, on identical numpy inputs, on the CPU.

Contract: ``encode``, ``encode_residual`` and ``encode_chunks`` of tnqsgd
and tqsgd at 3 bits, on a bucket of 3,001 elements (off a multiple of 32,
so ``encode_chunks`` pads it for 8 chunks and draws on the padded tile),
with the same plan and key under JAX's original threefry layout: every
wire bitwise and every residual bitwise.  JAX's side is its codec with
``use_pallas=False`` (the ``kernels.ref`` oracles), run eagerly: under
``jax.jit`` XLA's CPU code contracts the uniform residual's
``code·step − α`` into one fused multiply-add, which moves about half of
the elements by a unit in the last place, where the port and the eager
oracle round the product and the difference separately.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import compressors as jcomp  # noqa: E402
from repro.core.quantizers import QuantMeta as JQuantMeta  # noqa: E402
from repro_torch.core import codecs, compressors, prng  # noqa: E402

N, CHUNKS, BITS = 3001, 8, 3


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("method", ["tnqsgd", "tqsgd"])
def test_quantizer_codec_encodes_match_jax(method):
    rng = np.random.default_rng(N)
    flat = (1e-3 * rng.standard_normal(N) * np.exp(rng.standard_normal(N))).astype(np.float32)
    cfg = compressors.CompressorConfig(method=method, bits=BITS)
    jcfg = jcomp.CompressorConfig(method=method, bits=BITS)
    codec, jcodec = codecs.get_codec(method), jcodecs.get_codec(method)
    tflat = torch.from_numpy(flat)
    pln = codec.plan(cfg, tflat, None)
    jpln = JQuantMeta(levels=jnp.asarray(pln.levels.numpy()), alpha=jnp.asarray(pln.alpha.numpy()))

    def jencode(x, key):
        return (jcodec.encode(jcfg, x, jpln, jax.random.fold_in(key, 0), False),
                jcodec.encode_residual(jcfg, x, jpln, jax.random.fold_in(key, 1), False)[:2],
                jcodec.encode_chunks(jcfg, x, jpln, jax.random.fold_in(key, 2), CHUNKS, False))

    jwire, (jrw, jrr), (jcw, jcr) = jencode(jnp.asarray(flat), jax.random.key(7))
    key = prng.key(7)
    wire = codec.encode(cfg, tflat, pln, prng.fold_in(key, 0))
    rw, rr, aux = codec.encode_residual(cfg, tflat, pln, prng.fold_in(key, 1))
    cw, cr = codec.encode_chunks(cfg, tflat, pln, prng.fold_in(key, 2), CHUNKS)
    assert aux is None
    assert wire.shape == (codec.wire_words(cfg, N),) and (_bits(wire) == _bits(jwire)).all()
    assert (_bits(rw) == _bits(jrw)).all()
    assert cw.shape == (CHUNKS, codec.chunk_wire_words(cfg, N, CHUNKS))
    assert (_bits(cw) == _bits(jcw)).all()
    for got, want in ((rr, jrr), (cr, jcr)):
        assert got.shape == (N,) and (_bits(got) == _bits(want)).all()
