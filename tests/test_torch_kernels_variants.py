"""The plain PyTorch versions of kernels K3 and K5–K9 (``repro_torch.kernels
.ref``) and their ``kernels.ops`` wrappers against the JAX package's Pallas
kernels in interpret mode and its ``kernels.ref`` oracles, on identical
numpy inputs.

Contract, per kernel:
- K3, K6, K7 (uniform/codebook encode→pack[→residual]): wire words bitwise
  against both JAX versions;
- K3's residual, K5 and K9 (the uniform dequant ``code·2α/s − α``):
  bitwise against ``repro.kernels.ref`` run eagerly (measured equal: both
  round the multiply and the subtract separately), and within 4 ulp of the
  largest intermediate against the Pallas kernels in interpret mode, which
  contract the multiply-add — the JAX package's own contract between its
  two versions (``tests/test_decode_kernels.py``).  As for K4, the
  reductions meet the Pallas kernel at 2 and 4 peers and ``repro.kernels
  .ref`` alone at 3, where JAX's two versions divide by the peer count
  differently;
- K8 (codebook rows): bitwise against both.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode as jdec  # noqa: E402
from repro.kernels import encode_fused as jenc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SIZES = [999, 64 * 128 * 2 + 17]
PEER_COUNTS = [2, 3, 4]
ALPHA = np.float32(0.17)


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _assert_ulp_close(got, want, scale, ulps=4):
    """|got − want| ≤ ulps · ulp(scale), ``scale`` bounding the largest
    intermediate (``tests/test_decode_kernels.py``)."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert (diff <= ulps * np.spacing(np.float32(scale))).all(), float(diff.max())


def _bucket(seed: int, n: int):
    rng = np.random.default_rng(seed)
    g = (0.1 * rng.standard_normal(n)).astype(np.float32)
    rows = -(-n // 128)
    g2 = np.zeros(rows * 128, np.float32)
    g2[:n] = g
    g2 = g2.reshape(rows, 128)
    return g, g2, rng.random(g2.shape, dtype=np.float32)


def _levels(seed: int, bits: int) -> np.ndarray:
    lv = np.sort(np.random.default_rng(seed).uniform(-0.2, 0.2, 2**bits)).astype(np.float32)
    lv[0], lv[-1] = -0.2, 0.2
    return lv


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_uniform_encode_pack_residual_matches_pallas(bits, n):
    """K3 and K7 on one tile: words bitwise, residual within 4 ulp."""
    _, g2, rand = _bucket(bits * 11 + n, n)
    w, r = ref.uniform_encode_pack_residual(torch.from_numpy(g2), torch.from_numpy(rand),
                                            torch.tensor([ALPHA]), n, bits)
    jw, jr = jenc.uniform_encode_pack_resid_2d(jnp.asarray(g2), jnp.asarray(rand),
                                               jnp.asarray(ALPHA), n, bits=bits, interpret=True)
    assert w.shape == (g2.shape[0], 4 * bits) and w.dtype == torch.int32
    assert (w.numpy() == np.asarray(jw)).all()
    _assert_ulp_close(r.numpy(), jr, float(np.abs(g2).max() + ALPHA))
    w7 = ref.uniform_encode_pack(torch.from_numpy(g2), torch.from_numpy(rand),
                                 torch.tensor([ALPHA]), n, bits)
    jw7 = jenc.uniform_encode_pack_2d(jnp.asarray(g2), jnp.asarray(rand), jnp.asarray(ALPHA), n,
                                      bits=bits, interpret=True)
    assert (w7.numpy() == np.asarray(jw7)).all()


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_codebook_encode_pack_matches_pallas_bitwise(bits, n):
    """K6: the words of K2 without its residual."""
    _, g2, rand = _bucket(bits * 13 + n, n)
    lv = _levels(bits, bits)
    w = ref.codebook_encode_pack(torch.from_numpy(g2), torch.from_numpy(rand),
                                 torch.from_numpy(lv), n, bits)
    jw = jenc.codebook_encode_pack_2d(jnp.asarray(g2), jnp.asarray(rand), jnp.asarray(lv), n,
                                      bits=bits, interpret=True)
    assert (w.numpy() == np.asarray(jw)).all()


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_ops_encodes_with_key_match_jax(bits):
    """The wrappers' padded-tile draw: K3, K6 and K7 words and the K3
    residual bitwise against ``repro.kernels.ref``, which draws as the JAX
    wrappers do."""
    n = 3000
    g, _, _ = _bucket(bits, n)
    lv = _levels(bits + 1, bits)
    key = prng.fold_in(prng.key(0x5EED), bits)
    jkey = jax.random.fold_in(jax.random.key(0x5EED), bits)
    tg, ta = torch.from_numpy(g), torch.tensor(ALPHA)
    w, r = ops.uniform_encode_pack_residual(tg, ta, bits, key)
    jw, jr = jref.uniform_encode_pack_residual(jnp.asarray(g), jnp.asarray(ALPHA), bits, jkey)
    assert (w.numpy().view(np.uint32) == np.asarray(jw)).all()
    assert (_bits(r.numpy()) == _bits(jr)).all()
    for got, jfn, meta in ((ops.uniform_encode_pack(tg, ta, bits, key), "uniform_encode_pack",
                            ALPHA),
                           (ops.codebook_encode_pack(tg, torch.from_numpy(lv), bits, key),
                            "codebook_encode_pack", lv)):
        want = getattr(jref, jfn)(jnp.asarray(g), jnp.asarray(meta), bits, jkey)
        assert (got.numpy().view(np.uint32) == np.asarray(want)).all(), jfn


def test_uniform_encode_at_zero_alpha_matches_pallas():
    """α = 0 makes the scale infinite and u NaN; every version gives code 0
    and the residual g."""
    n = 999
    _, g2, rand = _bucket(5, n)
    w, r = ref.uniform_encode_pack_residual(torch.from_numpy(g2), torch.from_numpy(rand),
                                            torch.zeros(1), n, 3)
    jw, jr = jenc.uniform_encode_pack_resid_2d(jnp.asarray(g2), jnp.asarray(rand),
                                               jnp.float32(0.0), n, bits=3, interpret=True)
    assert (w.numpy() == 0).all() and (np.asarray(jw) == 0).all()
    assert (_bits(r.numpy()) == _bits(jr)).all() and (_bits(r.numpy()) == _bits(g2)).all()


def _wire(peers: int, bits: int, n: int):
    rng = np.random.default_rng(bits + n + peers)
    words = rng.integers(0, 2**32, (peers, (n + 31) // 32 * bits), dtype=np.uint64)
    levels = np.stack([_levels(10 * bits + p, bits) for p in range(peers)])
    alphas = rng.uniform(0.01, 0.3, peers).astype(np.float32)
    return words.astype(np.uint32), levels, alphas


def _pallas_words(words: np.ndarray, n: int, bits: int, block: int):
    """The wire as the Pallas decode takes it: rows padded to whole blocks."""
    w3 = ops._to_words3(torch.from_numpy(words.view(np.int32)), n, bits).numpy()
    peers, rows, _ = w3.shape
    pad = np.zeros((peers, -(-rows // block) * block, 4 * bits), np.int32)
    pad[:, :rows] = w3
    return jnp.asarray(pad)


@pytest.mark.parametrize("peers", PEER_COUNTS)
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_uniform_decode_reduce_matches_jax(peers, bits):
    """K5: bitwise against ``repro.kernels.ref``, within 4 ulp of Σα against
    the Pallas kernel at 2 and 4 peers."""
    n = SIZES[-1]
    words, _, alphas = _wire(peers, bits, n)
    got = ops.uniform_decode_reduce(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(alphas), n, bits).numpy()
    want = jref.uniform_decode_reduce(jnp.asarray(words), jnp.asarray(alphas), n, bits)
    assert (_bits(got) == _bits(want)).all()
    if peers == 3:
        return
    pw = _pallas_words(words, n, bits, jdec.BLOCK_ROWS)
    kern = jdec.uniform_decode_reduce_3d(pw, jnp.asarray(alphas).reshape(-1, 1), bits=bits,
                                         interpret=True)
    _assert_ulp_close(got, np.asarray(kern).reshape(-1)[:n], float(alphas.sum()))


@functools.lru_cache(maxsize=None)
def _jax_rows(bits: int):
    """K8 and K9 from both JAX versions on the widest wire of
    ``test_decode_rows_match_jax``.  The rows kernels decode every peer on
    its own, so a narrower wire (its first peers) decodes to the first rows:
    one compile per bit width instead of one per peer count."""
    n = SIZES[-1]
    words, levels, alphas = _wire(max(PEER_COUNTS), bits, n)
    peers = words.shape[0]
    kern8 = jdec.codebook_decode_rows_3d(_pallas_words(words, n, bits, jdec.BLOCK_ROWS_CODEBOOK),
                                         jnp.asarray(levels), bits=bits, interpret=True)
    kern9 = jdec.uniform_decode_rows_3d(_pallas_words(words, n, bits, jdec.BLOCK_ROWS),
                                        jnp.asarray(alphas).reshape(-1, 1), bits=bits,
                                        interpret=True)
    return dict(
        words=words, levels=levels, alphas=alphas,
        ref8=np.asarray(jref.codebook_decode_rows(jnp.asarray(words), jnp.asarray(levels), n, bits)),
        ref9=np.asarray(jref.uniform_decode_rows(jnp.asarray(words), jnp.asarray(alphas), n, bits)),
        kern8=np.asarray(kern8).reshape(peers, -1)[:, :n],
        kern9=np.asarray(kern9).reshape(peers, -1)[:, :n])


@pytest.mark.parametrize("peers", PEER_COUNTS)
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_decode_rows_match_jax(peers, bits):
    """K8 bitwise against both JAX versions; K9 bitwise against
    ``repro.kernels.ref`` and within 4 ulp of max α against Pallas (no
    division by the peer count, so at every peer count)."""
    n = SIZES[-1]
    jx = _jax_rows(bits)
    words, levels, alphas = jx["words"][:peers], jx["levels"][:peers], jx["alphas"][:peers]
    tw = torch.from_numpy(words.view(np.int32))
    got = ops.codebook_decode_rows(tw, torch.from_numpy(levels), n, bits).numpy()
    assert got.shape == (peers, n)
    assert (_bits(got) == _bits(jx["ref8"][:peers])).all()
    assert (_bits(got) == _bits(jx["kern8"][:peers])).all()
    got = ops.uniform_decode_rows(tw, torch.from_numpy(alphas), n, bits).numpy()
    assert (_bits(got) == _bits(jx["ref9"][:peers])).all()
    _assert_ulp_close(got, jx["kern9"][:peers], float(alphas.max()))
    # the plain versions on the padded tile agree with the wrappers
    w3 = ops._to_words3(tw, n, bits)
    band = ref.uniform_decode_rows(w3, torch.from_numpy(alphas), bits).reshape(peers, -1)
    assert torch.equal(band[:, :n], torch.from_numpy(got))
