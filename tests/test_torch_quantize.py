"""The plain PyTorch versions of kernels K12–K17 (``repro_torch.kernels
.ref``), through the port's ``kernels.ops`` wrappers on the CPU, against
``repro.kernels.ops`` (the Pallas kernels of ``repro.kernels.quantize`` in
interpret mode) on the same numpy inputs and the same key.

Contract, per kernel:
- K12, K14 (uniform/codebook encode) and K16, K17 (the same with the tail
  masked and the codes packed): codes and wire words bitwise, at n = 144
  and 200,000 (off 128) and 4,608, bits 2, 3 and 8; the words of K16/K17
  also equal ``pack_codes`` of K12/K14's codes from the same draw;
- K13 (``code·(2α/s) − α``): bitwise against ``repro.kernels.ref
  .uniform_decode`` run eagerly (both round the product and the difference
  apart), and within 4 ulp of α against the Pallas kernel, which contracts
  the multiply-add in interpret mode — the JAX package's own contract
  between its two versions (``tests/test_decode_kernels.py``);
- K15 (``levels[code]``): bitwise;
- the segmented K12 and K14 (one launch over many tiles): their plain
  versions bitwise per tile (K12's against the Pallas kernel), and the
  ``ops.*_encode_leaves`` wrappers bitwise the per-leaf wrappers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import prng, quantizers  # noqa: E402
from repro_torch.kernels import encode_fused, ops, quantize  # noqa: E402

SIZES = [144, 4608, 200_000]
BITS = [2, 3, 8]
ALPHA = np.float32(0.17)


@pytest.fixture(autouse=True)
def same_layout():
    """Pin JAX to the port's (original) threefry counter layout, then
    restore it."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _inputs(n: int, bits: int):
    rng = np.random.default_rng(n * 10 + bits)
    g = (0.1 * rng.standard_normal(n)).astype(np.float32)
    levels = np.sort(rng.uniform(-0.2, 0.2, 2**bits)).astype(np.float32)
    levels[0], levels[-1] = -0.2, 0.2
    return g, levels


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_encode_kernels_match_pallas(n, bits):
    """K12 codes, K16 codes and words."""
    g, _ = _inputs(n, bits)
    key = prng.key(n + bits)
    want, (jw, jc) = jax.jit(lambda x, a, k: (jops.uniform_encode(x, a, bits, k),
                                              jops.uniform_encode_packed(x, a, bits, k)))(
        jnp.asarray(g), jnp.float32(ALPHA), jax.random.key(n + bits))
    codes = ops.uniform_encode(torch.from_numpy(g), torch.tensor(ALPHA), bits, key)
    assert codes.dtype == torch.uint8 and (codes.numpy() == np.asarray(want)).all()
    words, pcodes = ops.uniform_encode_packed(torch.from_numpy(g), torch.tensor(ALPHA), bits, key)
    assert (_u32(words) == np.asarray(jw)).all() and (pcodes.numpy() == np.asarray(jc)).all()
    assert torch.equal(words, quantizers.pack_codes(codes, bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_codebook_encode_kernels_match_pallas(n, bits):
    """K14 codes, K17 codes and words."""
    g, levels = _inputs(n, bits)
    key = prng.key(n + bits)
    want, (jw, jc) = jax.jit(lambda x, lv, k: (jops.codebook_encode(x, lv, k),
                                               jops.codebook_encode_packed(x, lv, bits, k)))(
        jnp.asarray(g), jnp.asarray(levels), jax.random.key(n + bits))
    codes = ops.codebook_encode(torch.from_numpy(g), torch.from_numpy(levels), key)
    assert codes.dtype == torch.uint8 and (codes.numpy() == np.asarray(want)).all()
    words, pcodes = ops.codebook_encode_packed(torch.from_numpy(g), torch.from_numpy(levels), bits,
                                               key)
    assert (_u32(words) == np.asarray(jw)).all() and (pcodes.numpy() == np.asarray(jc)).all()
    assert torch.equal(words, quantizers.pack_codes(codes, bits))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_uniform_decode_kernel_matches_jax(n, bits):
    """K13: bitwise against the eager oracle, 4 ulp of α against Pallas."""
    codes = np.random.default_rng(n + bits).integers(0, 2**bits, n).astype(np.int32)
    a = jnp.float32(ALPHA)
    got = ops.uniform_decode(torch.from_numpy(codes), torch.tensor(ALPHA), bits).numpy()
    eager = np.asarray(jref.uniform_decode(jnp.asarray(codes), a, bits))
    assert (got.view(np.uint32) == eager.view(np.uint32)).all()
    pallas = np.asarray(jops.uniform_decode(jnp.asarray(codes), a, bits))
    assert (np.abs(got - pallas) <= 4 * np.spacing(ALPHA)).all()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", SIZES)
def test_codebook_decode_kernel_matches_pallas(n, bits):
    """K15 bitwise; the port's plain version also gives 0 for a code outside
    [0, s], as the Pallas kernel's one-hot product does."""
    _, levels = _inputs(n, bits)
    codes = np.random.default_rng(n + bits).integers(0, 2**bits, n).astype(np.int32)
    got = ops.codebook_decode(torch.from_numpy(codes), torch.from_numpy(levels)).numpy()
    want = np.asarray(jops.codebook_decode(jnp.asarray(codes), jnp.asarray(levels)))
    assert (got.view(np.uint32) == want.view(np.uint32)).all()
    out = ops.codebook_decode(torch.tensor([-1, 0, 2**bits - 1, 2**bits]), torch.from_numpy(levels))
    assert out.tolist() == [0.0, float(levels[0]), float(levels[-1]), 0.0]


# smallnet's eight leaf sizes, in tree_leaves order
LEAF_SIZES = [16, 144, 32, 4608, 128, 200_704, 10, 1280]


def test_segmented_codebook_encode_plain_bitwise():
    """The segmented plain K14 (one tile per leaf, each with its own
    codebook: s = 3, 7 and 255 mixed, as a bits_plan gives) stacks each
    tile's ``ref.codebook_encode`` codes bit for bit, and
    ``ops.codebook_encode_leaves`` returns ``ops.codebook_encode``'s codes of
    every leaf, past ``MAX_SEGMENTS`` leaves too."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(5)
    bits = [2, 3, 8, 3, 2, 3, 8, 2]
    gs = [torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
          for n in LEAF_SIZES]
    lvs = [torch.from_numpy(_inputs(n, b)[1]) for n, b in zip(LEAF_SIZES, bits)]
    keys = [prng.fold_in(prng.key(9), j) for j in range(len(gs))]
    drawn = [ops._draw(g, k) for g, k in zip(gs, keys)]
    g2s, rands = [d[0] for d in drawn], [d[2] for d in drawn]
    codes = ref.codebook_encode_segments(g2s, rands, lvs)
    assert codes.shape == (sum(g2.shape[0] for g2 in g2s), 128) and codes.dtype == torch.int32
    row = 0
    for g2, rand, lv in zip(g2s, rands, lvs):
        assert torch.equal(codes[row:row + g2.shape[0]], ref.codebook_encode(g2, rand, lv))
        row += g2.shape[0]
    before = kernels.launch_counts()
    small = [g[:n] for g in gs for n in (10, 130)] * 5        # 80 leaves: two launches' worth
    slv = [lv for lv in lvs for _ in (0, 1)] * 5
    skeys = [prng.fold_in(prng.key(10), j) for j in range(len(small))]
    for i, c in enumerate(ops.codebook_encode_leaves(small, slv, skeys) +
                          ops.codebook_encode_leaves(gs, lvs, keys)):
        g, lv, k = (small[i], slv[i], skeys[i]) if i < len(small) else (
            gs[i - len(small)], lvs[i - len(small)], keys[i - len(small)])
        assert torch.equal(c, ops.codebook_encode(g, lv, k))
    assert kernels.launch_counts() == before


def test_segmented_codebook_encode_rejects_bad_tables():
    """The segmented K14 wrapper refuses CPU tensors, a tile whose rand does
    not match its g, and more than ``MAX_SEGMENTS`` tiles."""
    g2, lv = torch.zeros((2, 128)), torch.linspace(-1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        quantize.codebook_encode_segments([g2, g2], [g2, g2], [lv, lv])
    with pytest.raises(ValueError, match="rand must match"):
        quantize.codebook_encode_segments([g2, g2], [g2, g2[:1]], [lv, lv])
    k = quantize.MAX_SEGMENTS + 1
    for tiles in ([], [g2] * k):
        with pytest.raises(ValueError, match="tiles"):
            quantize.codebook_encode_segments(tiles, tiles, [lv] * len(tiles))
    with pytest.raises(ValueError, match="tiles"):
        quantize.codebook_encode_segments([g2, g2], [g2, g2], [lv])


# smallnet's leaf sizes below 200,704 elements, at mixed widths
SMALL_LEAVES = [n for n in LEAF_SIZES if n < 200_704]
SMALL_BITS = [2, 3, 8, 3, 2, 8, 3]


def test_segmented_uniform_encode_plain_matches_jax():
    """The segmented plain K12 over smallnet's leaf tiles below 200,704
    elements, each with its own α and width: each tile's codes bitwise the
    JAX package's per-tile encode (its Pallas kernel in interpret mode, all
    tiles in one jit) on the same key."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(11)
    gs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in SMALL_LEAVES]
    alphas = [np.float32(0.05 + 0.02 * i) for i in range(len(gs))]
    seeds = [300 + i for i in range(len(gs))]
    want = jax.jit(lambda xs, als: [jops.uniform_encode(x, a, b, jax.random.key(k))
                                    for x, a, b, k in zip(xs, als, SMALL_BITS, seeds)])(
        [jnp.asarray(g) for g in gs], [jnp.float32(a) for a in alphas])
    drawn = [ops._draw(torch.from_numpy(g), prng.key(k)) for g, k in zip(gs, seeds)]
    g2s, rands = [d[0] for d in drawn], [d[2] for d in drawn]
    codes = ref.uniform_encode_segments(g2s, rands, [torch.tensor([a]) for a in alphas],
                                        SMALL_BITS)
    assert codes.shape == (sum(g2.shape[0] for g2 in g2s), 128) and codes.dtype == torch.int32
    row = 0
    for (g2, n, _), w in zip(drawn, want):
        assert (codes[row:row + g2.shape[0]].reshape(-1)[:n].numpy() == np.asarray(w)).all()
        row += g2.shape[0]


def test_uniform_encode_leaves_equal_per_leaf_encodes():
    """``ops.uniform_encode_leaves`` returns ``ops.uniform_encode``'s codes
    of every leaf, each with its own α and width, past ``MAX_SEGMENTS``
    leaves too, and counts no launch on the CPU."""
    rng = np.random.default_rng(12)
    gs = [torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
          for n in LEAF_SIZES + [10, 130] * 30]                # 68 leaves: two launches' worth
    alphas = [torch.tensor(0.05 + 0.001 * i) for i in range(len(gs))]
    bits = [SMALL_BITS[i % len(SMALL_BITS)] for i in range(len(gs))]
    keys = [prng.fold_in(prng.key(13), j) for j in range(len(gs))]
    before = kernels.launch_counts()
    for g, a, b, k, c in zip(gs, alphas, bits, keys, ops.uniform_encode_leaves(gs, alphas, bits,
                                                                              keys)):
        assert torch.equal(c, ops.uniform_encode(g, a, b, k))
    assert kernels.launch_counts() == before


def test_segmented_uniform_encode_rejects_bad_tables():
    """The segmented K12 wrapper refuses CPU tensors, a tile whose rand does
    not match its g, more than ``MAX_SEGMENTS`` tiles and a bits list of
    another length."""
    g2, a = torch.zeros((2, 128)), torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        quantize.uniform_encode_segments([g2, g2], [g2, g2], [a, a], [3, 3])
    with pytest.raises(ValueError, match="rand must match"):
        quantize.uniform_encode_segments([g2, g2], [g2, g2[:1]], [a, a], [3, 3])
    k = quantize.MAX_SEGMENTS + 1
    with pytest.raises(ValueError, match="tiles"):
        quantize.uniform_encode_segments([g2] * k, [g2] * k, [a] * k, [3] * k)
    with pytest.raises(ValueError, match="bits"):
        quantize.uniform_encode_segments([g2, g2], [g2, g2], [a, a], [3])


def test_launch_count_keys_are_distinct():
    """K16/K17 share their TPU names with K7/K6: the counts are keyed by
    module and name, one key for each of the 17 kernels."""
    names = [kernels.kernel_name(k) for k in kernels.KERNELS]
    assert len(names) == len(set(names)) == 17
    assert quantize.uniform_encode_pack_2d.__name__ == encode_fused.uniform_encode_pack_2d.__name__
    for k in (quantize.uniform_encode_pack_2d, quantize.codebook_encode_pack_2d,
              encode_fused.uniform_encode_pack_2d, encode_fused.codebook_encode_pack_2d,
              quantize.uniform_encode_2d, quantize.uniform_decode_2d,
              quantize.codebook_encode_2d, quantize.codebook_decode_2d):
        assert kernels.kernel_name(k) in kernels.launch_counts()
    assert kernels.kernel_name(quantize.codebook_encode_pack_2d) == "quantize.codebook_encode_pack_2d"
    assert kernels.kernel_name(encode_fused.codebook_encode_pack_2d) == (
        "encode_fused.codebook_encode_pack_2d")


def test_quantize_kernels_refuse_cpu_tensors():
    """The K12–K17 wrappers take CUDA tensors only; ``ops`` sends CPU
    tensors to the plain versions without touching a launch counter."""
    g2, alpha, levels = torch.zeros((2, 128)), torch.ones(1), torch.linspace(-1, 1, 8)
    codes2 = torch.zeros((2, 128), dtype=torch.int32)
    for call in (lambda: quantize.uniform_encode_2d(g2, g2, alpha, 3),
                 lambda: quantize.codebook_encode_2d(g2, g2, levels),
                 lambda: quantize.uniform_encode_pack_2d(g2, g2, alpha, 200, 3),
                 lambda: quantize.codebook_encode_pack_2d(g2, g2, levels, 200, 3),
                 lambda: quantize.uniform_decode_2d(codes2, alpha, 3),
                 lambda: quantize.codebook_decode_2d(codes2, levels)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = kernels.launch_counts()
    ops.codebook_encode_packed(torch.ones(300), levels, 3, prng.key(0))
    ops.uniform_decode(torch.zeros(300, dtype=torch.uint8), alpha, 3)
    assert kernels.launch_counts() == before
