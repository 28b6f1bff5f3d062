"""The plain PyTorch versions of the port's kernels (``repro_torch.kernels
.ref``) and the dispatching wrappers (``kernels.ops``) against the JAX
package's Pallas kernels in interpret mode and its ``kernels.ref`` oracles,
on identical numpy inputs.

Contract, per kernel:
- K2 (codebook encode→pack→residual): wire words and residual bitwise;
- K4 (codebook decode→peer mean): bitwise.  The JAX package's own two
  versions disagree by an ulp when the peer count is not a power of two
  (its Pallas kernel in interpret mode rounds the division by the peer
  count differently), so
  the port — which divides, like ``repro.kernels.ref`` and the CUDA
  kernel — is held to ``repro.kernels.ref`` at 3 peers and to both at 2
  and 4;
- K1/K10 (EF-correct + statistics): counts exact on inputs kept at least
  0.1% (relative) from every bin edge, max exact, the ln and moment sums
  within rtol 1e-5 (of each bin's sum, and of Σ|x| for the signed sum);
  also on the extremes: all zeros (bin 0), all overflow (bin 127), n = 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode as jdec  # noqa: E402
from repro.kernels import encode_fused as jenc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import stats as jstats  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import encode_fused as kenc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import stats as kstats  # noqa: E402

SIZES = [999, 64 * 128 * 2 + 17]
RTOL = 1e-5


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _off_edge(seed: int, n: int) -> np.ndarray:
    """Signed values over every bin, under- and overflow included, each at
    least 0.1% (relative) from a bin edge; 1% exact zeros."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-8, 140, n)
    mag = 2.0 ** (-24 + 0.25 * (b + rng.uniform(0.01, 0.99, n)))
    x = (rng.choice([-1.0, 1.0], n) * mag).astype(np.float32)
    x[rng.random(n) < 0.01] = 0.0
    return x


def _stats_input(kind: str, seed: int, n: int) -> np.ndarray:
    """``_off_edge``, all zeros, or every |x| at or above 2^8 (bin 127)."""
    if kind == "zeros":
        return np.zeros(n, np.float32)
    if kind == "overflow":
        rng = np.random.default_rng(seed)
        return (rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(8, 20, n)).astype(np.float32)
    return _off_edge(seed, n)


# the sizes, on off-edge inputs (ids unchanged), then the extremes
STATS_CASES = [pytest.param("off_edge", n, id=str(n)) for n in SIZES] + [
    pytest.param("zeros", 300, id="zeros-300"), pytest.param("overflow", 300, id="overflow-300"),
    pytest.param("off_edge", 1, id="one-1")]


def _pad2d(x: np.ndarray) -> np.ndarray:
    rows = -(-x.size // 128)
    out = np.zeros(rows * 128, np.float32)
    out[:x.size] = x
    return out.reshape(rows, 128)


def _levels(seed: int, bits: int) -> np.ndarray:
    lv = np.sort(np.random.default_rng(seed).uniform(-0.2, 0.2, 2**bits)).astype(np.float32)
    lv[0], lv[-1] = -0.2, 0.2
    return lv


def _assert_stats(got: np.ndarray, want: np.ndarray, x: np.ndarray, n: int):
    assert (got[0] == want[0]).all() and got[0].sum() == n
    assert (got[2] == want[2]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=0)
    assert abs(got[3, 0] - want[3, 0]) <= RTOL * np.abs(x[:n]).sum()
    np.testing.assert_allclose(got[4], want[4], rtol=RTOL, atol=0)
    assert (got[5:] == 0).all()


@pytest.mark.parametrize("kind, n", STATS_CASES)
def test_bucket_stats_matches_pallas(kind, n):
    x = _stats_input(kind, n, n)
    x2 = _pad2d(x)
    got = ref.bucket_stats(torch.from_numpy(x2), n).numpy()
    _assert_stats(got, np.asarray(jstats.bucket_stats_2d(jnp.asarray(x2), n, interpret=True)), x, n)
    _assert_stats(got, np.asarray(jref.bucket_stats(jnp.asarray(x))), x, n)
    s = ops.bucket_stats(torch.from_numpy(x))
    assert torch.equal(torch.stack([s.counts, s.log_sums]), torch.from_numpy(got[:2]))


@pytest.mark.parametrize("kind, n", STATS_CASES)
def test_ef_correct_stats_matches_pallas(kind, n):
    x = _stats_input(kind, n + 1, n)
    e = (x * 1e-7 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    g2, e2 = _pad2d(x - e), _pad2d(e)
    c2, got = ref.ef_correct_stats(torch.from_numpy(g2), torch.from_numpy(e2), n)
    jc2, want = jenc.ef_correct_stats_2d(jnp.asarray(g2), jnp.asarray(e2), n, interpret=True)
    assert (c2.numpy().view(np.uint32) == np.asarray(jc2).view(np.uint32)).all()
    _assert_stats(got.numpy(), np.asarray(want), c2.numpy().reshape(-1), n)
    c, s = ops.ef_correct_stats(torch.from_numpy(x - e), torch.from_numpy(e))
    assert torch.equal(c, c2.reshape(-1)[:n]) and torch.equal(s.g_max, got[2, 0])


@pytest.mark.parametrize("kind", ["zeros", "overflow"])
def test_bucket_stats_one_bin_within_rtol_of_float64(kind):
    """With every element of a bucket in one bin (smallnet's 206,922), the
    plain version's ln and moment sums stay within rtol 1e-5 of the float64
    sums of the same float32 terms: each tile sums in float64, rounded
    once (a float32 per-tile sum drifted by 1.12e-4 here).  The terms are
    the plain version's own: torch's CPU ``log`` over the same 8,192-element
    tiles (one worker thread's chunk of it has been seen to differ from
    ``np.log`` by up to 1.4e-4, ROADMAP Queue 3 F5), so only the sums are
    held."""
    n = 206_922
    x = _stats_input(kind, 11, n)
    got = ref.bucket_stats(torch.from_numpy(_pad2d(x)), n).numpy()
    tiles = np.zeros(-(-n // 8192) * 8192, np.float32)
    tiles[:n] = np.abs(x)
    ln = torch.log(torch.clamp_min(torch.from_numpy(tiles), 1e-30)).numpy()[:n].astype(np.float64)
    xd = x.astype(np.float64)
    assert got[0, 0 if kind == "zeros" else 127] == n
    np.testing.assert_allclose(got[1].sum(), ln.sum(), rtol=RTOL, atol=0)
    assert abs(got[3, 0] - xd.sum()) <= RTOL * np.abs(xd).sum()
    np.testing.assert_allclose(got[4, 0], (xd * xd).sum(), rtol=RTOL, atol=0)


def test_ef_correct_stats_takes_ef_rows_as_they_lie():
    """A row of an (n_clients, s) EF state at an odd offset, or a strided
    view, gives what its contiguous copy gives, bitwise."""
    n = 999
    g = torch.from_numpy(_off_edge(5, n))
    state = torch.from_numpy(1e-4 * np.random.default_rng(5).standard_normal((3, n), np.float32))
    want_c, want = ops.ef_correct_stats(g, state[1].clone())
    spread = torch.zeros(2 * n)
    spread[::2] = state[1]
    for e in (state[1], spread[::2]):
        c, s = ops.ef_correct_stats(g, e)
        assert torch.equal(c, want_c)
        assert all(torch.equal(a, b) for a, b in zip(s, want))


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_codebook_encode_pack_residual_bitwise(bits, n):
    rng = np.random.default_rng(bits * 7 + n)
    g2 = _pad2d((0.1 * rng.standard_normal(n)).astype(np.float32))
    rand = rng.random(g2.shape, dtype=np.float32)
    lv = _levels(bits, bits)
    w, r = ref.codebook_encode_pack_residual(torch.from_numpy(g2), torch.from_numpy(rand),
                                             torch.from_numpy(lv), n, bits)
    jw, jr = jenc.codebook_encode_pack_resid_2d(jnp.asarray(g2), jnp.asarray(rand),
                                                jnp.asarray(lv), n, bits=bits, interpret=True)
    assert w.shape == (g2.shape[0], 4 * bits) and w.dtype == torch.int32
    assert (w.numpy() == np.asarray(jw)).all()
    assert (r.numpy().view(np.uint32) == np.asarray(jr).view(np.uint32)).all()


@pytest.mark.parametrize("bits", [2, 3])
def test_ops_encode_with_key_matches_jax(bits):
    """The wrapper's padded-tile uniform draw reproduces the JAX wrapper's."""
    n = 3000
    g = (0.1 * np.random.default_rng(bits).standard_normal(n)).astype(np.float32)
    lv = _levels(bits + 1, bits)
    jkey = jax.random.fold_in(jax.random.key(0x5EED), 5)
    w, r = ops.codebook_encode_pack_residual(torch.from_numpy(g), torch.from_numpy(lv), bits,
                                             prng.fold_in(prng.key(0x5EED), 5))
    jw, jr = jops.codebook_encode_pack_residual(jnp.asarray(g), jnp.asarray(lv), bits, jkey)
    assert (w.numpy().view(np.uint32) == np.asarray(jw)).all()
    assert (r.numpy().view(np.uint32) == np.asarray(jr).view(np.uint32)).all()


def _wire(peers: int, bits: int, n: int):
    rng = np.random.default_rng(bits + n + peers)
    words = rng.integers(0, 2**32, (peers, (n + 31) // 32 * bits), dtype=np.uint64)
    levels = np.stack([_levels(10 * bits + p, bits) for p in range(peers)])
    return words.astype(np.uint32), levels


@pytest.mark.parametrize("peers", [2, 3, 4])
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_codebook_decode_reduce_matches_ref_bitwise(peers, bits):
    n = SIZES[-1]
    words, levels = _wire(peers, bits, n)
    got = ops.codebook_decode_reduce(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(levels), n, bits).numpy()
    want = np.asarray(jref.codebook_decode_reduce(jnp.asarray(words), jnp.asarray(levels), n, bits))
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


@pytest.mark.parametrize("peers", [2, 4])
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_codebook_decode_reduce_matches_pallas_bitwise(peers, bits):
    n = SIZES[-1]
    words, levels = _wire(peers, bits, n)
    w3 = ops._to_words3(torch.from_numpy(words.view(np.int32)), n, bits)
    rows = w3.shape[1]
    pad = np.zeros((peers, -(-rows // 64) * 64, 4 * bits), np.int32)
    pad[:, :rows] = w3.numpy()
    want = np.asarray(jdec.codebook_decode_reduce_3d(jnp.asarray(pad), jnp.asarray(levels),
                                                     bits=bits, interpret=True))
    got = ref.codebook_decode_reduce(w3, torch.from_numpy(levels), bits).numpy()
    assert (got.view(np.uint32) == want[:rows].view(np.uint32)).all()


def test_cpu_tensors_take_the_plain_version_only():
    """The kernel wrappers refuse CPU tensors; ops sends them to ``ref``
    without touching a launch counter."""
    g2 = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kstats.bucket_stats_2d(g2, 200)
    with pytest.raises(ValueError, match="CUDA"):
        kstats.bucket_stats_flat(g2.reshape(-1), 200)
    with pytest.raises(ValueError, match="CUDA"):
        kenc.ef_correct_stats_flat(g2.reshape(-1), g2.reshape(-1), 200)
    before = kernels.launch_counts()
    ops.bucket_stats(torch.ones(300))
    assert kernels.launch_counts() == before
