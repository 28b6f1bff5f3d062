"""The port's core math (``repro_torch.core``) against ``repro.core`` on
identical numpy inputs.

Packed wire words are bitwise equal.  Plans from identical one-pass
statistics agree to rtol 1e-4 in α and every level.  exp2, pow, log, the
interpolation and the cumulative sums may each differ by an ulp between
the two packages (XLA blocks a cumsum, torch accumulates it in double), and
the Hill estimator's ``Σ ln g − n_tail·ln g_min`` cancels, which amplifies
those ulps in γ and α: up to 3.1e-5 relative from identical statistics,
measured on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compressors as jcomp  # noqa: E402
from repro.core import quantizers as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import codecs, compressors, quantizers  # noqa: E402


def _heavy(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (1e-3 * rng.standard_normal(n) * np.exp(rng.standard_normal(n))).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 999])
def test_pack_unpack_bitwise(bits, n):
    codes = np.random.default_rng(n * 10 + bits).integers(0, 2**bits, n).astype(np.uint8)
    want = np.asarray(jq.pack_codes(jnp.asarray(codes), bits))
    got = quantizers.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32 and got.shape == (quantizers.packed_size(n, bits),)
    assert (got.numpy().view(np.uint32) == want).all()
    back = quantizers.unpack_codes(got, n, bits).numpy()
    assert (back == np.asarray(jq.unpack_codes(jnp.asarray(want), n, bits))).all()
    assert (back == codes).all()


def test_linspace_and_interp_match_jnp():
    for start, stop, num in [(0.0, 1.0, 129), (-0.37, 0.37, 8), (0.0, 3.3e-3, 256)]:
        got = quantizers.linspace(torch.tensor(start), torch.tensor(stop), num).numpy()
        np.testing.assert_allclose(got, np.asarray(jnp.linspace(start, stop, num)),
                                   rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    xp = np.sort(rng.random(40)).astype(np.float32)
    xp[5] = xp[4]                                  # a zero-width interval
    fp = rng.standard_normal(40).astype(np.float32)
    x = np.concatenate([rng.random(200) * 1.4 - 0.2, xp]).astype(np.float32)
    got = quantizers.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.interp(x, xp, fp)),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def stats_tiles() -> list[np.ndarray]:
    """(8, 128) statistics of two buckets, from the JAX oracle: a lognormal
    mix whose tail index clips at GAMMA_MIN, and a Student-t whose does not."""
    t = (1e-3 * np.random.default_rng(5).standard_t(3.5, 20_000)).astype(np.float32)
    return [np.array(jref.bucket_stats(jnp.asarray(x))) for x in (_heavy(3, 20_000), t)]


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("method", ["tnqsgd", "nqsgd", "tqsgd", "qsgd"])
@pytest.mark.parametrize("bits", [2, 8])
def test_plan_from_stats_matches(stats_tiles, tile, method, bits):
    st = stats_tiles[tile]
    want = jcomp.plan_from_stats(jcomp.CompressorConfig(method=method, bits=bits),
                                 jnp.asarray(st[0]), jnp.asarray(st[1]), jnp.asarray(st[2, 0]))
    t = torch.from_numpy(st)
    got = compressors.plan_from_stats(compressors.CompressorConfig(method=method, bits=bits),
                                      t[0], t[1], t[2, 0])
    np.testing.assert_allclose(float(got.alpha), float(want.alpha), rtol=1e-4)
    np.testing.assert_allclose(got.levels.numpy(), np.asarray(want.levels), rtol=1e-4,
                               atol=1e-4 * float(want.alpha))
    assert got.levels.dtype == torch.float32 and (torch.diff(got.levels) > 0).all()


def test_wire_and_bucket_geometry_match():
    sizes = [16, 144, 32, 4608, 128, 200704, 10, 1280]
    for target in (1 << 18, 1000, 4700):
        want = jcomp.plan_buckets(sizes, target)
        got = compressors.plan_buckets(sizes, target)
        assert (got.ranges, got.sizes) == (want.ranges, want.sizes)
    for bits in (1, 3, 8):
        jc = jcomp.CompressorConfig(bits=bits)
        tc = compressors.CompressorConfig(bits=bits)
        assert compressors.wire_bytes(tc, sizes) == jcomp.wire_bytes(jc, sizes)
        assert codecs.get_codec("tnqsgd").wire_words(tc, 206_922) == \
            jcomp.wire_bytes(jc, 206_922) // 4 - 1
    leaves = [torch.arange(6.0).reshape(2, 3), torch.ones(4), torch.zeros(1, 1, 5)]
    bp = compressors.plan_buckets([6, 4, 5], 10)
    back = compressors.bucket_split(compressors.bucket_concat(leaves, bp), bp,
                                    [x.shape for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(leaves, back))


def test_config_validation():
    with pytest.raises(ValueError):
        compressors.CompressorConfig(bits=9)
    with pytest.raises(ValueError):
        compressors.CompressorConfig(method="nope")
    assert compressors.CompressorConfig(method="fp16").method == "fp16"
    assert compressors.CompressorConfig(method="powersgd", rank=8).rank == 8
    assert codecs.bucket_state_sizes(compressors.CompressorConfig(), [5, 7]) == [5, 7]
    assert codecs.size_adaptive_plan(compressors.CompressorConfig(), None, [5, 700], 10) == \
        (("fp16", 3), compressors.CompressorConfig())
    from repro.core import codecs as jcodecs

    assert jcodecs.size_adaptive_plan(jcomp.CompressorConfig(), None, [5, 700], 10) == \
        (("fp16", 3), jcomp.CompressorConfig())
