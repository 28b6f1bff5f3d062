"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU, ``nvcc`` and no JAX; every test is marked ``gpu`` and
skips without a card.  Run them on the card with
``python3 -m pytest -q -m gpu tests/test_torch_gpu.py``.

Contract: K2, K3, K6, K7 words and residuals, K4, K5, K8, K9 outputs and
K12–K17 codes, words and values bitwise (the kernels are built with
``-fmad=false`` and IEEE division, so the uniform dequant rounds as the
plain version's separate ops do); K1/K10
counts and max exact, the ln and moment sums within rtol 1e-5 (of each
bin's sum, and of Σ|x| for the signed sum), and bitwise equal across two
launches, across the (rows, 128) and the flat path and across a buffer's
alignment; K11 within rtol 1e-5 / atol 1e-6 of its plain version (the
sums run in another order), exact zeros for zero columns, and bitwise
equal across two launches, the register and the global-memory path bitwise
equal; the segmented K14 and K12 bitwise equal to their plain versions
and to the one-tile kernel on each tile; the decode body bitwise the
serial body it replaced, and equal from the padded words and from the
stacked wire as it lies; the encode body (K2, K3, K6, K7) bitwise the
serial body it replaced, and equal from the flat entry on the bucket as it
lies (any 4-byte alignment, shorter than the code length); K16 and K17 on
the same body, their codes K12's and K14's zeroed past n, the same from
the flat entry and through ``kernels.ops`` on the unpadded tensor.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.quantizers import pack_codes, packed_size  # noqa: E402
from repro_torch.kernels import (decode, encode_fused, ops, orthogonalize, quantize,  # noqa: E402
                                 ref, stats)

pytestmark = pytest.mark.gpu
SIZES = [999, 64 * 128 * 2 + 17, 70_000]
RTOL = 1e-5
# tests/test_lowrank.py's shapes, then smallnet's and a full 4 MB bucket's P
# factor (809 and 1,024 rows) at rank 4, the rank cap 64 and rank 1, the
# mixed plan's (784, 4) and the smallest shapes
GS_SHAPES = [(8, 4), (128, 8), (1000, 3), (7, 7), (513, 16), (809, 4), (1024, 4), (1024, 64),
             (809, 1), (784, 4), (1, 1), (7, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _heavy(gen, n, device, scale=1e-3):
    z = torch.randn(n, generator=gen, device=device)
    return scale * z * torch.exp(torch.randn(n, generator=gen, device=device))


def _assert_stats(got, want, x2, n):
    assert torch.equal(got[0], want[0]) and float(got[0].sum()) == n
    assert torch.equal(got[2], want[2])
    assert bool((torch.abs(got[1] - want[1]) <= RTOL * torch.abs(want[1])).all())
    assert float(torch.abs(got[3, 0] - want[3, 0])) <= RTOL * float(x2.reshape(-1)[:n].abs().sum())
    assert bool((torch.abs(got[4] - want[4]) <= RTOL * want[4]).all())


@pytest.mark.parametrize("n", SIZES)
def test_stats_kernels_match_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    g2 = ops._to_2d(_heavy(gen, n, cuda))[0]
    e2 = ops._to_2d(_heavy(gen, n, cuda, 1e-4))[0]
    out = stats.bucket_stats_2d(g2, n)
    assert torch.equal(stats.bucket_stats_2d(g2, n), out)
    _assert_stats(out, ref.bucket_stats(g2, n), g2, n)
    c2, out1 = encode_fused.ef_correct_stats_2d(g2, e2, n)
    c2b, out1b = encode_fused.ef_correct_stats_2d(g2, e2, n)
    assert torch.equal(c2, c2b) and torch.equal(out1, out1b)
    c_ref, s_ref = ref.ef_correct_stats(g2, e2, n)
    assert torch.equal(c2, c_ref)
    _assert_stats(out1, s_ref, c2, n)


# one element, a ragged warp, one past a kernel block, smallnet's bucket and
# one past a 4 MB bucket, ragged
STATS_N = [1, 127, 2049, 206_922, 1_048_593]


def _stats_input(kind: str, seed: int, n: int, device) -> torch.Tensor:
    """``every_bin``: signed values over every bin, each at least 0.1%
    (relative) from a bin edge, under- and overflow included, with 1% exact
    zeros and 1% subnormals (tests/test_torch_kernels.py::_off_edge and
    more); ``zeros``; ``overflow``: every |x| at or above 2^8 (bin 127)."""
    gen = torch.Generator().manual_seed(seed)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0).double()
    u = 0.01 + 0.98 * torch.rand(n, generator=gen, dtype=torch.float64)
    if kind == "zeros":
        x = torch.zeros(n, dtype=torch.float64)
    elif kind == "overflow":
        x = sign * torch.exp2(8 + 12 * u)
    else:
        b = torch.randint(-8, 140, (n,), generator=gen).double()
        x = sign * torch.exp2(-24 + 0.25 * (b + u))
        r = torch.rand(n, generator=gen)
        x[r < 0.01] = 0.0
        sub = (r >= 0.01) & (r < 0.02)
        x[sub] = sign[sub] * 2.0**-130 * u[sub]
    return x.to(torch.float32).to(device)


def _assert_sums_exact(got, x, n):
    """Rows 1, 3 and 4 within rtol 1e-5 of the float64 sums of the same
    float32 terms (ln|x| binned as the kernel bins it, x, x²)."""
    x = x.reshape(-1)[:n]
    ln = torch.log(torch.clamp_min(torch.abs(x), 1e-30))
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=x.device)
    b = torch.clamp(torch.floor((ln / ln2 + 24.0) / 0.25), 0, 127).long()
    want = torch.zeros(128, dtype=torch.float64, device=x.device).index_add_(0, b, ln.double())
    assert bool((torch.abs(got[1].double() - want) <= RTOL * torch.abs(want)).all())
    xd = x.double()
    assert abs(float(got[3, 0]) - float(xd.sum())) <= RTOL * float(xd.abs().sum())
    assert abs(float(got[4, 0]) - float((xd * xd).sum())) <= RTOL * float((xd * xd).sum())


@pytest.mark.parametrize("kind", ["every_bin", "zeros", "overflow"])
@pytest.mark.parametrize("n", STATS_N)
def test_stats_kernels_on_every_bin(cuda, kind, n):
    """K10 and K1 through the (rows, 128) wrappers and the flat path, the
    EF row at an odd offset as a row of the sync's (n_clients, s) state
    can lie, each launched twice.  Counts and max bitwise the plain
    version's; the sums within rtol 1e-5 of the float64 sums and, on the
    every-bin input, of the plain version's.  With one bin holding every
    element (zeros, overflow) the plain version's own per-bin sum is off by
    more than that (a sequential ``index_add`` of 8,192 equal terms)."""
    g = _stats_input(kind, n, n, cuda)
    e = _stats_input(kind, n + 1, n, cuda) * 2.0**-10
    g2, e2 = ops._to_2d(g)[0], ops._to_2d(e)[0]
    c_ref, s_ref = ref.ef_correct_stats(g2, e2, n)
    for tile, want, x2 in ((stats.bucket_stats_2d(g2, n), ref.bucket_stats(g2, n), g2),
                           (encode_fused.ef_correct_stats_2d(g2, e2, n)[1], s_ref, c_ref)):
        assert torch.equal(tile[0], want[0]) and float(tile[0].sum()) == n
        assert torch.equal(tile[2], want[2]) and bool((tile[5:] == 0).all())
        if kind == "every_bin":
            _assert_stats(tile, want, x2, n)
        _assert_sums_exact(tile, x2, n)
    tile = stats.bucket_stats_2d(g2, n)
    assert torch.equal(stats.bucket_stats_2d(g2, n), tile)
    assert torch.equal(stats.bucket_stats_flat(g, n), tile)
    c2, tile1 = encode_fused.ef_correct_stats_2d(g2, e2, n)
    c2b, tile1b = encode_fused.ef_correct_stats_2d(g2, e2, n)
    assert torch.equal(c2, c2b) and torch.equal(tile1, tile1b)
    assert torch.equal(c2, c_ref)
    buf = torch.zeros(n + 1, device=cuda)
    buf[1:] = e
    e_odd = buf[1:]
    assert e_odd.data_ptr() % 16 != 0
    for ef in (e, e_odd):
        for _ in range(2):
            c, tile_flat = encode_fused.ef_correct_stats_flat(g, ef, n)
            assert torch.equal(c, c2.reshape(-1)[:n]) and torch.equal(tile_flat, tile1)
    c, st = ops.ef_correct_stats(g, e_odd)
    assert torch.equal(c, c_ref.reshape(-1)[:n])
    assert torch.equal(torch.stack([st.counts, st.log_sums]), tile1[:2])
    assert torch.equal(torch.stack([st.g_max, st.g_sum, st.g_sumsq]), tile1[2:5, 0])


def test_stats_kernels_carry_inf(cuda):
    """An infinite element lands in bin 127 with ln = inf, as in the plain
    version; the max and the moment sums are inf."""
    n = 5000
    g = _stats_input("every_bin", 7, n, cuda)
    g[17] = g[4000] = float("inf")
    g2 = ops._to_2d(g)[0]
    want = ref.bucket_stats(g2, n)
    for tile in (stats.bucket_stats_2d(g2, n), stats.bucket_stats_flat(g, n),
                 encode_fused.ef_correct_stats_2d(g2, torch.zeros_like(g2), n)[1]):
        assert torch.equal(tile[0], want[0]) and torch.equal(tile[2:5], want[2:5])
        assert float(tile[1, 127]) == float("inf") == float(want[1, 127])
        assert bool((torch.abs(tile[1, :127] - want[1, :127])
                     <= RTOL * torch.abs(want[1, :127])).all())


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_encode_and_decode_kernels_bitwise(cuda, bits, n):
    gen = torch.Generator(device=cuda).manual_seed(bits * 100 + n)
    peers = 3
    words, levels = [], []
    for p in range(peers):
        g2 = ops._to_2d(_heavy(gen, n, cuda, 0.05))[0]
        lv = torch.sort(torch.rand(2**bits, generator=gen, device=cuda) * 0.4 - 0.2).values
        lv[0], lv[-1] = -0.2, 0.2
        rand = prng.uniform(prng.key(p), g2.shape, device=cuda)
        w, r = encode_fused.codebook_encode_pack_resid_2d(g2, rand, lv, n, bits)
        w_ref, r_ref = ref.codebook_encode_pack_residual(g2, rand, lv, n, bits)
        assert torch.equal(w, w_ref) and torch.equal(r, r_ref)
        words.append(w)
        levels.append(lv)
    words3, levels2 = torch.stack(words), torch.stack(levels)
    mean = decode.codebook_decode_reduce_3d(words3, levels2, bits)
    assert torch.equal(mean, ref.codebook_decode_reduce(words3, levels2, bits))


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_variant_kernels_bitwise(cuda, bits, n):
    """K3, K6, K7 against their plain versions; K5, K8, K9 over their words."""
    gen = torch.Generator(device=cuda).manual_seed(bits * 300 + n)
    peers = 3
    uwords, cwords, alphas, levels = [], [], [], []
    for p in range(peers):
        g2 = ops._to_2d(_heavy(gen, n, cuda, 0.05))[0]
        rand = prng.uniform(prng.key(p + 7), g2.shape, device=cuda)
        alpha = (0.05 + 0.2 * torch.rand(1, generator=gen, device=cuda)).contiguous()
        w, r = encode_fused.uniform_encode_pack_resid_2d(g2, rand, alpha, n, bits)
        w_ref, r_ref = ref.uniform_encode_pack_residual(g2, rand, alpha, n, bits)
        assert torch.equal(w, w_ref) and torch.equal(r, r_ref)
        assert torch.equal(encode_fused.uniform_encode_pack_2d(g2, rand, alpha, n, bits), w_ref)
        lv = torch.sort(torch.rand(2**bits, generator=gen, device=cuda) * 0.4 - 0.2).values
        lv[0], lv[-1] = -0.2, 0.2
        wc = encode_fused.codebook_encode_pack_2d(g2, rand, lv, n, bits)
        assert torch.equal(wc, ref.codebook_encode_pack(g2, rand, lv, n, bits))
        assert torch.equal(wc, encode_fused.codebook_encode_pack_resid_2d(g2, rand, lv, n, bits)[0])
        uwords.append(w)
        cwords.append(wc)
        alphas.append(alpha)
        levels.append(lv)
    uw3, cw3 = torch.stack(uwords), torch.stack(cwords)
    a2, l2 = torch.cat(alphas), torch.stack(levels)
    assert torch.equal(decode.uniform_decode_reduce_3d(uw3, a2, bits),
                       ref.uniform_decode_reduce(uw3, a2, bits))
    assert torch.equal(decode.uniform_decode_rows_3d(uw3, a2, bits),
                       ref.uniform_decode_rows(uw3, a2, bits))
    assert torch.equal(decode.codebook_decode_rows_3d(cw3, l2, bits),
                       ref.codebook_decode_rows(cw3, l2, bits))


def test_wrappers_count_launches_and_reject_bad_operands(cuda):
    kernels.reset_launch_counts()
    g = torch.randn(5000, device=cuda)
    ops.bucket_stats(g)
    ops.ef_correct_stats(g, g)
    words, _ = ops.codebook_encode_pack_residual(g, torch.linspace(-1, 1, 8, device=cuda), 3,
                                                 prng.key(0))
    lv = torch.linspace(-1, 1, 8, device=cuda)
    ops.codebook_decode_reduce(words[None], lv[None], 5000, 3)
    a = torch.tensor(1.0, device=cuda)
    uw, _ = ops.uniform_encode_pack_residual(g, a, 3, prng.key(1))
    ops.uniform_encode_pack(g, a, 3, prng.key(2))
    ops.codebook_encode_pack(g, lv, 3, prng.key(3))
    ops.uniform_decode_reduce(uw[None], a.reshape(1), 5000, 3)
    ops.uniform_decode_rows(uw[None], a.reshape(1), 5000, 3)
    ops.codebook_decode_rows(words[None], lv[None], 5000, 3)
    ops.orthogonalize(torch.randn(809, 4, device=cuda))
    codes = ops.uniform_encode(g, a, 3, prng.key(4))
    ops.uniform_decode(codes, a, 3)
    ops.codebook_decode(ops.codebook_encode(g, lv, prng.key(5)), lv)
    ops.uniform_encode_packed(g, a, 3, prng.key(6))
    ops.codebook_encode_packed(g, lv, 3, prng.key(7))
    assert kernels.launch_counts() == {kernels.kernel_name(k): 1 for k in kernels.KERNELS}
    with pytest.raises(ValueError):
        stats.bucket_stats_2d(torch.zeros((4, 64), device=cuda), 10)
    with pytest.raises(ValueError):
        encode_fused.codebook_encode_pack_resid_2d(
            torch.zeros((4, 128), device=cuda), torch.zeros((4, 128), device=cuda),
            torch.zeros(4, device=cuda), 10, 3)
    with pytest.raises(ValueError):
        encode_fused.uniform_encode_pack_2d(
            torch.zeros((4, 128), device=cuda), torch.zeros((4, 128), device=cuda),
            torch.zeros(2, device=cuda), 10, 3)
    with pytest.raises(ValueError):
        decode.uniform_decode_rows_3d(torch.zeros((2, 4, 12), dtype=torch.int32, device=cuda),
                                      torch.zeros(3, device=cuda), 3)


# the decode body (K4, K5, K8, K9): every width a codebook can have up to
# 8 bits that the tests use, one peer, an odd count, one batch of 8, one
# past it and two full batches; a last row that is partial and one
# ragged past a multiple of 32
DECODE_BITS = [1, 2, 3, 4, 8]
DECODE_PEERS = [1, 3, 8, 9, 16]
RAGGED_N = 100_003


@pytest.mark.parametrize("peers", DECODE_PEERS)
@pytest.mark.parametrize("bits", DECODE_BITS)
def test_decode_body_bitwise(cuda, bits, peers):
    """Each of K4, K5, K8, K9 on random wire words: bitwise its plain
    version and the replaced serial body on the padded (peers, rows,
    4·bits) words, and the same bits from the stacked wire as it lies, its
    rows contiguous or strided (the codec's layout, levels after the
    words), through ``decode.from_wire`` and the ``kernels.ops`` wrappers."""
    from repro_torch.core.quantizers import packed_size

    gen = torch.Generator(device=cuda).manual_seed(bits * 100 + peers)
    for n in (1000, RAGGED_N):
        w = packed_size(n, bits)
        wide = torch.randint(-2**31, 2**31, (peers, w + 9), generator=gen, device=cuda,
                             dtype=torch.int64).to(torch.int32)
        strided = wide[:, :w]
        wire = strided.contiguous()
        words3 = ops._to_words3(wire, n, bits)
        levels = torch.sort(torch.randn(peers, 2**bits, generator=gen, device=cuda), 1).values
        alphas = 0.05 + torch.rand(peers, generator=gen, device=cuda)
        for kernel, plain, meta, uniform, reduce, wrap in (
                (decode.codebook_decode_reduce_3d, ref.codebook_decode_reduce, levels, False, True,
                 ops.codebook_decode_reduce),
                (decode.uniform_decode_reduce_3d, ref.uniform_decode_reduce, alphas, True, True,
                 ops.uniform_decode_reduce),
                (decode.codebook_decode_rows_3d, ref.codebook_decode_rows, levels, False, False,
                 ops.codebook_decode_rows),
                (decode.uniform_decode_rows_3d, ref.uniform_decode_rows, alphas, True, False,
                 ops.uniform_decode_rows)):
            kernels.reset_launch_counts()
            got = kernel(words3, meta, bits)
            assert torch.equal(got, plain(words3, meta, bits)), (kernel.__name__, n)
            assert torch.equal(got, decode.serial_3d(uniform, reduce, words3, meta, bits))
            for x in (wire, strided):
                assert torch.equal(decode.from_wire(kernel, x, meta, n, bits), got)
                flat = got.reshape(-1)[:n] if reduce else got.reshape(peers, -1)[:, :n]
                assert torch.equal(wrap(x, meta, n, bits), flat)
            assert kernels.launch_counts()[kernels.kernel_name(kernel)] == 5


def test_decode_wire_entry_rejects_bad_wires(cuda):
    lv = torch.zeros(2, 8, device=cuda)
    wire = torch.zeros((2, 96), dtype=torch.int32, device=cuda)     # 1,024 elements at 3 bits
    for words, n, bits in ((wire, 1100, 3), (wire[:, :95], 1024, 3),
                           (wire.T.contiguous().T, 1024, 3),
                           (wire.cpu(), 1024, 3), (wire.float(), 1024, 3), (wire, 1024, 9)):
        with pytest.raises(ValueError):
            decode.from_wire(decode.codebook_decode_reduce_3d, words, lv, n, bits)
    with pytest.raises(ValueError):
        decode.from_wire(decode.codebook_decode_reduce_3d, wire, lv[:1], 1024, 3)


# the encode body (K2, K3, K6, K7): every width a codebook can have up to 8
# bits that the tests use (in registers up to 4, in shared memory above),
# at a partial last row, off a multiple of 32, smallnet's bucket, a 4 MB
# bucket and the two_phase (8,) and (2, 4)-pod chunks of smallnet's bucket
ENCODE_BITS = [1, 2, 3, 4, 8]
ENCODE_N = [1000, RAGGED_N, 206_922, 1_048_576, 25_888, 51_744]
ENCODES = [(encode_fused.codebook_encode_pack_resid_2d, ref.codebook_encode_pack_residual, False,
            True, ops.codebook_encode_pack_residual),
           (encode_fused.uniform_encode_pack_resid_2d, ref.uniform_encode_pack_residual, True,
            True, ops.uniform_encode_pack_residual),
           (encode_fused.codebook_encode_pack_2d, ref.codebook_encode_pack, False, False, None),
           (encode_fused.uniform_encode_pack_2d, ref.uniform_encode_pack, True, False, None)]


def _encode_meta(gen, bits, device):
    levels = torch.sort(1e-3 * torch.randn(2**bits, generator=gen, device=device)).values
    alpha = 1e-3 + 2e-3 * torch.rand(1, generator=gen, device=device)
    return levels, alpha


def _outs(out, resid):
    return out if resid else (out,)


@pytest.mark.parametrize("n", ENCODE_N)
@pytest.mark.parametrize("bits", ENCODE_BITS)
def test_encode_body_bitwise(cuda, bits, n):
    """Each of K2, K3, K6, K7 on the padded tile: bitwise its plain version
    and the replaced serial body, and the same words and residual from the
    flat entry on the bucket as it lies."""
    gen = torch.Generator(device=cuda).manual_seed(bits * 1000 + n)
    g2 = ops._to_2d(_heavy(gen, n, cuda))[0]
    rand = prng.uniform(prng.key(bits + n), g2.shape, device=cuda)
    levels, alpha = _encode_meta(gen, bits, cuda)
    for kernel, plain, uniform, resid, _ in ENCODES:
        meta = alpha if uniform else levels
        got = _outs(kernel(g2, rand, meta, n, bits), resid)
        want = _outs(plain(g2, rand, meta, n, bits), resid)
        serial = _outs(encode_fused.serial_2d(uniform, resid, g2, rand, meta, n, bits), resid)
        for a, b, c in zip(got, want, serial):
            assert torch.equal(a, b) and torch.equal(a, c), (kernel.__name__, bits, n)
        flat = _outs(encode_fused.encode_flat(kernel, g2.reshape(-1)[:n], n, rand, meta, bits),
                     resid)
        assert torch.equal(flat[0], got[0])
        if resid:
            assert torch.equal(flat[1], got[1].reshape(-1)[:n])


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_encode_flat_entry_on_stacked_rows(cuda, bits):
    """The flat entry on the rows of a stacked (peers, m) bucket, every
    other one off a 16-byte boundary, at the code length encode_chunks
    gives (m < n): equal to the kernel on the row zero-padded to n, and,
    through ``kernels.ops`` with its draw, to the plain version on the CPU.
    Each flat launch counts under its kernel; the serial body counts none."""
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.compressors import CompressorConfig

    m, peers = 3001, 4
    n = peers * get_codec("tnqsgd").chunk_elems(CompressorConfig(bits=bits), m, peers)
    gen = torch.Generator(device=cuda).manual_seed(bits)
    stacked = _heavy(gen, peers * m, cuda).reshape(peers, m)
    levels, alpha = _encode_meta(gen, bits, cuda)
    rand = prng.uniform(prng.key(bits), (-(-n // 128), 128), device=cuda)
    assert n > m and {row.data_ptr() % 16 for row in stacked} == {0, 4, 8, 12}
    for kernel, _, uniform, resid, wrap in ENCODES:
        meta = alpha if uniform else levels
        for i, row in enumerate(stacked):
            kernels.reset_launch_counts()
            got = _outs(encode_fused.encode_flat(kernel, row, n, rand, meta, bits), resid)
            encode_fused.serial_2d(uniform, resid, ops._to_2d(row, n=n)[0], rand, meta, n, bits)
            assert kernels.launch_counts() == {
                kernels.kernel_name(k): int(k is kernel) for k in kernels.KERNELS}
            want = _outs(kernel(ops._to_2d(row, n=n)[0], rand, meta, n, bits), resid)
            assert torch.equal(got[0], want[0]), (kernel.__name__, i)
            if resid:
                assert got[1].shape == (m,) and torch.equal(got[1], want[1].reshape(-1)[:m])
                key = prng.key(10 + i)
                card = wrap(row, meta, bits, key, n=n)
                cpu = wrap(row.cpu(), meta.cpu(), bits, key, n=n)
                assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))


def test_encode_flat_entry_rejects_bad_buckets(cuda):
    lv = torch.linspace(-1, 1, 8, device=cuda)
    c = torch.randn(1000, device=cuda)
    rand = prng.uniform(prng.key(0), (8, 128), device=cuda)
    kernel = encode_fused.codebook_encode_pack_resid_2d
    encode_fused.encode_flat(kernel, c, 1000, rand, lv, 3)
    wide = torch.empty(8 * 128 + 1, device=cuda)
    for bucket, n, r in ((torch.randn(2000, device=cuda)[::2], 1000, rand),  # not contiguous
                         (c.half(), 1000, rand), (c.cpu(), 1000, rand),
                         (c, 999, rand),                                     # m > n
                         (c, 1100, rand),                                    # tile of 1,024
                         (c, 1000, rand[:7]), (c, 1000, rand.double()),
                         (c, 1000, wide[1:].view(8, 128))):                  # rand 4 bytes off
        with pytest.raises(ValueError):
            encode_fused.encode_flat(kernel, bucket, n, r, lv, 3)
    with pytest.raises(ValueError):
        encode_fused.encode_flat(kernel, c, 1000, rand, lv, 9)


# K12-K17 at every leaf size of smallnet (each a tile shape the per-tensor
# path gives them) and a full 4 MB tensor
Q_SIZES = [10, 16, 32, 128, 144, 1280, 4608, 200_704, 1_048_576]


@pytest.mark.parametrize("bits", [2, 3, 8])
@pytest.mark.parametrize("n", Q_SIZES)
def test_quantize_kernels_bitwise(cuda, bits, n):
    """Against the plain versions, with α and the levels of the per-tensor
    plan that the path uses."""
    from repro_torch.core.compressors import CompressorConfig, plan

    gen = torch.Generator(device=cuda).manual_seed(bits * 7 + n)
    g = _heavy(gen, n, cuda, 0.05)
    g2 = ops._to_2d(g)[0]
    rand = prng.uniform(prng.key(n), g2.shape, device=cuda)
    lv = plan(CompressorConfig(method="tnqsgd", bits=bits), g).levels
    a = plan(CompressorConfig(method="tqsgd", bits=bits), g).alpha.reshape(1).contiguous()
    uc = quantize.uniform_encode_2d(g2, rand, a, bits)
    assert torch.equal(uc, ref.uniform_encode(g2, rand, a, bits))
    cc = quantize.codebook_encode_2d(g2, rand, lv)
    assert torch.equal(cc, ref.codebook_encode(g2, rand, lv))
    for kernel, plain, meta, codes in ((quantize.uniform_encode_pack_2d,
                                        ref.uniform_encode_pack_codes, a, uc),
                                       (quantize.codebook_encode_pack_2d,
                                        ref.codebook_encode_pack_codes, lv, cc)):
        pc, words = kernel(g2, rand, meta, n, bits)
        want_codes, want_words = plain(g2, rand, meta, n, bits)
        assert torch.equal(pc, want_codes) and torch.equal(words, want_words)
        assert torch.equal(pc.reshape(-1)[:n], codes.reshape(-1)[:n])
        assert torch.equal(words.reshape(-1)[:(n + 31) // 32 * bits],
                           pack_codes(codes.reshape(-1)[:n], bits))
    assert torch.equal(quantize.uniform_decode_2d(uc, a, bits), ref.uniform_decode(uc, a, bits))
    assert torch.equal(quantize.codebook_decode_2d(cc, lv), ref.codebook_decode(cc, lv))


# K16 and K17 on the encode body at every width (the codebook in registers
# up to 4 bits, in shared memory above): n under one row, off a multiple of
# 32, off a multiple of 128
PACK_N = [100, 1000, RAGGED_N]


@pytest.mark.parametrize("bits", range(1, 9))
def test_packed_quantize_body_bitwise(cuda, bits):
    """K16 and K17 on the padded tile: bitwise their plain versions, their
    codes K12's and K14's zeroed past n, their words ``pack_codes`` of
    those codes; the same from the flat entry on the tensor as it lies,
    16-byte aligned or 4 bytes off, and through ``kernels.ops`` on the
    unpadded tensor, also against the plain version on the CPU."""
    gen = torch.Generator(device=cuda).manual_seed(bits)
    levels, alpha = _encode_meta(gen, bits, cuda)
    for n in PACK_N:
        g = _heavy(gen, n, cuda)
        g2 = ops._to_2d(g)[0]
        key = prng.key(n + bits)
        rand = prng.uniform(key, g2.shape, device=cuda)
        buf = torch.empty(n + 1, device=cuda)
        buf[1:] = g
        for kernel, plain, meta, wrap, unpacked in (
                (quantize.uniform_encode_pack_2d, ref.uniform_encode_pack_codes, alpha,
                 ops.uniform_encode_packed, lambda: quantize.uniform_encode_2d(g2, rand, alpha,
                                                                                bits)),
                (quantize.codebook_encode_pack_2d, ref.codebook_encode_pack_codes, levels,
                 ops.codebook_encode_packed, lambda: quantize.codebook_encode_2d(g2, rand, levels))):
            kernels.reset_launch_counts()
            codes, words = kernel(g2, rand, meta, n, bits)
            want_codes, want_words = plain(g2, rand, meta, n, bits)
            assert torch.equal(codes, want_codes) and torch.equal(words, want_words), (bits, n)
            flat = unpacked().reshape(-1)[:n]
            assert torch.equal(codes.reshape(-1)[:n], flat) and not codes.reshape(-1)[n:].any()
            wire = words.reshape(-1)[:packed_size(n, bits)]
            assert torch.equal(wire, pack_codes(flat, bits))
            for x in (g, buf[1:]):
                got = encode_fused.encode_flat(kernel, x, n, rand, meta, bits)
                assert torch.equal(got[0], codes) and torch.equal(got[1], words), x.data_ptr() % 16
            card = wrap(g, meta, bits, key)
            assert torch.equal(card[0], wire) and torch.equal(card[1], flat.to(torch.uint8))
            cpu = wrap(g.cpu(), meta.cpu(), bits, key)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
            assert kernels.launch_counts()[kernels.kernel_name(kernel)] == 4


def test_quantize_kernels_reject_bad_operands(cuda):
    g2, rand = torch.zeros((4, 128), device=cuda), torch.zeros((4, 128), device=cuda)
    a, lv = torch.ones(1, device=cuda), torch.linspace(-1, 1, 8, device=cuda)
    shifted = torch.zeros(4 * 128 + 1, device=cuda)[1:].view(4, 128)   # 4 bytes off
    for call in (lambda: quantize.uniform_encode_2d(g2, rand, torch.ones(2, device=cuda), 3),
                 lambda: quantize.uniform_encode_2d(g2, rand[:2], a, 3),
                 lambda: quantize.codebook_encode_2d(g2, rand, torch.ones(257, device=cuda)),
                 lambda: quantize.codebook_encode_pack_2d(g2, rand, lv, 10, 2),
                 lambda: quantize.codebook_encode_pack_2d(g2, shifted, lv, 10, 3),
                 lambda: quantize.uniform_encode_pack_2d(g2, rand, a, 513, 3),
                 lambda: quantize.uniform_encode_pack_2d(g2, rand, a, 100, 9),
                 lambda: quantize.uniform_decode_2d(g2, a, 3),
                 lambda: quantize.codebook_decode_2d(g2.to(torch.int32), lv.double())):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("case", ["smallnet-2", "smallnet-3", "smallnet-8", "mixed", "one",
                                  "sixty-four"])
def test_segmented_codebook_encode_bitwise(cuda, case):
    """The segmented K14 in one launch against the plain version per tile
    and against the one-tile kernel: smallnet's eight leaf tiles at one
    width, with mixed widths (a bits_plan), one tile, and 64 tiles."""
    from repro_torch.core.compressors import CompressorConfig, plan

    sizes = [16, 144, 32, 4608, 128, 200_704, 10, 1280]
    widths = {"mixed": [2, 3, 8, 3, 2, 3, 8, 2], "one": [3], "sixty-four": [3, 2, 8, 3] * 16}
    bits = widths[case] if case in widths else [int(case.rsplit("-", 1)[-1])] * 8
    sizes = {"one": [200_704], "sixty-four": [sizes[i % 8] for i in range(64)]}.get(case, sizes)
    gen = torch.Generator(device=cuda).manual_seed(len(bits) * 10 + bits[0])
    g2s, rands, lvs = [], [], []
    for i, (n, b) in enumerate(zip(sizes, bits)):
        g = _heavy(gen, n, cuda, 0.05)
        g2s.append(ops._to_2d(g)[0])
        rands.append(prng.uniform(prng.key(100 + i), g2s[-1].shape, device=cuda))
        lvs.append(plan(CompressorConfig(method="tnqsgd", bits=b), g).levels)
    kernels.reset_launch_counts()
    codes = quantize.codebook_encode_segments(g2s, rands, lvs)
    assert kernels.launch_counts()["quantize.codebook_encode_2d"] == 1
    assert torch.equal(codes, ref.codebook_encode_segments(g2s, rands, lvs))
    row = 0
    for g2, rand, lv in zip(g2s, rands, lvs):
        assert torch.equal(codes[row:row + g2.shape[0]], quantize.codebook_encode_2d(g2, rand, lv))
        row += g2.shape[0]


def test_segmented_codebook_encode_rejects_bad_tables(cuda):
    g2, lv = torch.zeros((4, 128), device=cuda), torch.linspace(-1, 1, 8, device=cuda)
    kernels.reset_launch_counts()
    for call in (lambda: quantize.codebook_encode_segments([g2] * 65, [g2] * 65, [lv] * 65),
                 lambda: quantize.codebook_encode_segments([g2, g2], [g2, g2[:2]], [lv, lv]),
                 lambda: quantize.codebook_encode_segments([g2, g2.cpu()], [g2, g2.cpu()],
                                                           [lv, lv]),
                 lambda: quantize.codebook_encode_segments([g2, g2], [g2, g2],
                                                           [lv, torch.ones(257, device=cuda)]),
                 lambda: quantize.codebook_encode_segments([g2, g2.double()], [g2, g2.double()],
                                                           [lv, lv])):
        with pytest.raises(ValueError):
            call()
    assert kernels.launch_counts()["quantize.codebook_encode_2d"] == 0


@pytest.mark.parametrize("case", ["smallnet-2", "smallnet-3", "smallnet-8", "mixed", "one",
                                  "sixty-four"])
def test_segmented_uniform_encode_bitwise(cuda, case):
    """The segmented K12 in one launch against the plain version per tile
    and against the one-tile kernel: smallnet's eight leaf tiles at one
    width, with mixed widths (2, 3 and 8), one tile, and 64 tiles, each
    with the α of the per-tensor plan."""
    from repro_torch.core.compressors import CompressorConfig, plan

    sizes = [16, 144, 32, 4608, 128, 200_704, 10, 1280]
    widths = {"mixed": [2, 3, 8, 3, 2, 3, 8, 2], "one": [3], "sixty-four": [3, 2, 8, 3] * 16}
    bits = widths[case] if case in widths else [int(case.rsplit("-", 1)[-1])] * 8
    sizes = {"one": [200_704], "sixty-four": [sizes[i % 8] for i in range(64)]}.get(case, sizes)
    gen = torch.Generator(device=cuda).manual_seed(len(bits) * 10 + bits[0] + 1)
    g2s, rands, alphas = [], [], []
    for i, (n, b) in enumerate(zip(sizes, bits)):
        g = _heavy(gen, n, cuda, 0.05)
        g2s.append(ops._to_2d(g)[0])
        rands.append(prng.uniform(prng.key(200 + i), g2s[-1].shape, device=cuda))
        alphas.append(plan(CompressorConfig(method="tqsgd", bits=b), g).alpha.reshape(1)
                      .contiguous())
    kernels.reset_launch_counts()
    codes = quantize.uniform_encode_segments(g2s, rands, alphas, bits)
    assert kernels.launch_counts()["quantize.uniform_encode_2d"] == 1
    assert torch.equal(codes, ref.uniform_encode_segments(g2s, rands, alphas, bits))
    row = 0
    for g2, rand, a, b in zip(g2s, rands, alphas, bits):
        assert torch.equal(codes[row:row + g2.shape[0]], quantize.uniform_encode_2d(g2, rand, a, b))
        row += g2.shape[0]


def test_segmented_uniform_encode_rejects_bad_tables(cuda):
    g2, a = torch.zeros((4, 128), device=cuda), torch.ones(1, device=cuda)
    kernels.reset_launch_counts()
    for call in (lambda: quantize.uniform_encode_segments([g2] * 65, [g2] * 65, [a] * 65, [3] * 65),
                 lambda: quantize.uniform_encode_segments([g2, g2], [g2, g2[:2]], [a, a], [3, 3]),
                 lambda: quantize.uniform_encode_segments([g2, g2.cpu()], [g2, g2.cpu()],
                                                          [a, a.cpu()], [3, 3]),
                 lambda: quantize.uniform_encode_segments([g2, g2], [g2, g2],
                                                          [a, torch.ones(2, device=cuda)], [3, 3]),
                 lambda: quantize.uniform_encode_segments([g2, g2], [g2, g2], [a, a], [3, 9])):
        with pytest.raises(ValueError):
            call()
    assert kernels.launch_counts()["quantize.uniform_encode_2d"] == 0


def test_per_tensor_training_runs_through_k12_and_k14(cuda):
    from repro_torch.train import train_clients

    for method, name in (("tnqsgd", "quantize.codebook_encode_2d"),
                         ("tqsgd", "quantize.uniform_encode_2d")):
        kernels.reset_launch_counts()
        acc, hist = train_clients(method, 3, rounds=1, eval_batch=64, use_pallas=True,
                                  device="cuda")
        counts = kernels.launch_counts()
        assert len(hist) == 1 and hist[0] == hist[0] and 0.0 <= acc <= 1.0
        # one segmented launch per client: K14 for tnqsgd, K12 for tqsgd
        assert counts[name] == 8 and sum(counts.values()) == 8


@pytest.mark.parametrize("shape", GS_SHAPES)
def test_orthogonalize_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(shape[0] * 100 + shape[1])
    p = torch.randn(*shape, generator=gen, device=cuda)
    out = orthogonalize.orthogonalize_2d(p)
    assert torch.equal(orthogonalize.orthogonalize_2d(p), out)
    torch.testing.assert_close(out, ref.orthogonalize(p), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("shape", GS_SHAPES)
def test_orthogonalize_paths_agree_bitwise(cuda, shape):
    """The register and the global-memory path reduce in one order: the
    same bits wherever the factor fits in registers (every main-path shape;
    (513, 16) and (1024, 64) take the global path)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[0] * 7 + shape[1])
    p = torch.randn(*shape, generator=gen, device=cuda)
    glob = orthogonalize._launch(p, False)
    assert orthogonalize.on_chip(p) == (shape not in ((513, 16), (1024, 64)))
    if orthogonalize.on_chip(p):
        assert torch.equal(orthogonalize._launch(p, True), glob)
    assert torch.equal(orthogonalize.orthogonalize_2d(p), glob)


def test_orthogonalize_kernel_zero_and_dependent_columns(cuda):
    p = torch.zeros((64, 4), device=cuda)
    p[:, 0] = 1.0
    q = ops.orthogonalize(p)
    assert bool((q[:, 1:] == 0).all()) and torch.equal(q[:, 0], torch.full((64,), 0.125, device=cuda))
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = torch.randn(809, 4, generator=gen, device=cuda)
    p[:, 2] = 0.5 * p[:, 0] + 2.0 * p[:, 1]
    p[:, 3] = p[:, 1]
    q, want = ops.orthogonalize(p), ref.orthogonalize(p)
    scale = float(p.abs().max())
    for x in (q, want):
        torch.testing.assert_close(x.T @ x, torch.eye(4, device=cuda), rtol=0, atol=1e-5)
        torch.testing.assert_close(x @ (x.T @ p), p, rtol=0, atol=1e-5 * scale)


def test_orthogonalize_counts_launches_and_rejects_bad_operands(cuda):
    kernels.reset_launch_counts()
    ops.orthogonalize(torch.randn(100, 4, device=cuda))
    assert kernels.launch_counts()["orthogonalize.orthogonalize_2d"] == 1
    for bad in (torch.zeros((16, 65), device=cuda),                       # rank above 64
                torch.zeros((16, 0), device=cuda),                        # rank 0
                torch.zeros((0, 4), device=cuda),                         # no rows
                torch.zeros(16, device=cuda),                             # not 2-D
                torch.zeros((16, 4), device=cuda).double(),               # dtype
                torch.zeros((4, 16), device=cuda).T,                      # not contiguous
                torch.zeros((16, 4))):                                    # not on the card
        with pytest.raises(ValueError):
            orthogonalize.orthogonalize_2d(bad)
    assert kernels.launch_counts()["orthogonalize.orthogonalize_2d"] == 1


def test_synced_training_runs_through_the_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(error_feedback=True, steps=2, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 2 and all(h == h for h in hist)
    assert counts["encode_fused.ef_correct_stats_2d"] == 16
    assert counts["encode_fused.codebook_encode_pack_resid_2d"] == 16
    assert counts["decode.codebook_decode_reduce_3d"] == 2 and counts["stats.bucket_stats_2d"] == 0


def test_two_phase_tqsgd_runs_through_the_uniform_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(sync="two_phase", method="tqsgd", steps=1, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 1 and hist[0] == hist[0]
    assert counts["encode_fused.uniform_encode_pack_resid_2d"] == 8
    assert counts["decode.uniform_decode_reduce_3d"] == 8
    assert counts["encode_fused.uniform_encode_pack_2d"] == 8
    assert counts["decode.uniform_decode_rows_3d"] == 1
    assert counts["stats.bucket_stats_2d"] == 16


def test_powersgd_training_runs_through_k11(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(method="powersgd", error_feedback=True, steps=2, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 2 and all(h == h for h in hist)
    assert counts["encode_fused.ef_correct_stats_2d"] == 16
    assert counts["orthogonalize.orthogonalize_2d"] == 16
    assert sum(counts.values()) == 32


# the per-leaf codec's row shapes (bucket_mb=0): smallnet's leaves split
# over 8 peers (rows of 2 and 4), a (2, 4) pod, the 144- and 4,608-element
# leaves' rows (18, 576), over 1, 2, 4 and 8 peers
PER_LEAF_N = [2, 4, 18, 576]


@pytest.mark.parametrize("method", ["tnqsgd", "tqsgd"])
@pytest.mark.parametrize("n", PER_LEAF_N)
def test_per_leaf_rows_bitwise(cuda, n, method):
    """K6/K7 then K4/K5 and K8/K9 through ``core.codecs`` as the per-leaf
    sync calls them, on rows planned by the sort-based fit: the card's
    words, means and rows bitwise the plain versions' on the CPU."""
    from repro_torch.core import codecs
    from repro_torch.core.compressors import CompressorConfig, plan

    cfg = CompressorConfig(method=method, bits=3)
    gen = torch.Generator(device=cuda).manual_seed(n)
    for peers in (1, 2, 4, 8):
        rows = [_heavy(gen, n, cuda) for _ in range(peers)]
        metas = [plan(cfg, x) for x in rows]
        keys = [prng.fold_in(prng.key(n), p) for p in range(peers)]
        wire = torch.stack([codecs.encode_pack(cfg, x, m, k) for x, m, k in zip(rows, metas, keys)])
        cpu_metas = [m._replace(levels=m.levels.cpu(), alpha=m.alpha.cpu()) for m in metas]
        wire_cpu = torch.stack([codecs.encode_pack(cfg, x.cpu(), m, k)
                                for x, m, k in zip(rows, cpu_metas, keys)])
        assert wire.shape == (peers, packed_size(n, 3)) and torch.equal(wire.cpu(), wire_cpu)
        levels = torch.stack([m.levels for m in metas])
        for op in (codecs.decode_reduce, codecs.decode_rows):
            assert torch.equal(op(cfg, wire, levels, n).cpu(), op(cfg, wire_cpu, levels.cpu(), n))


def test_per_leaf_training_runs_through_the_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(sync="two_phase", bucket_mb=0, steps=1, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 1 and hist[0] == hist[0]
    assert counts["encode_fused.codebook_encode_pack_2d"] == 576
    assert counts["decode.codebook_decode_reduce_3d"] == 64
    assert counts["decode.codebook_decode_rows_3d"] == 8
    assert sum(counts.values()) == 648


# -- elastic participation and the compression metrics -----------------------

DROPOUT_LIVE = [4, 7, 7, 8, 6, 6, 4, 6, 6, 5, 8, 6, 7, 7, 5, 5, 7, 8, 6, 5, 5, 7, 6, 6, 8, 7, 6,
                7, 7, 5]
SMALLNET_SHAPES = [(16,), (3, 3, 1, 16), (32,), (3, 3, 16, 32), (128,), (1568, 128), (10,),
                   (128, 10)]
# pod 0 of a (2, 4) layout and peer 5 dropped
ELASTIC_LIVE = [0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0]


def test_dropout_golden_on_the_card(cuda):
    """The JAX package's 20%-dropout EF golden (faithful tnqsgd, 3 bits):
    0.0938 ± 0.07 after 30 steps from 6.4895, bit for bit twice, every peer
    encoding each step (K1 8, K2 8, K4 1)."""
    from repro_torch.elastic import ElasticConfig, live_mask
    from repro_torch.train import train_synced

    cfg = ElasticConfig(rate=0.2, seed=0x17E)
    assert [int(live_mask(cfg, i, 8, cuda).sum()) for i in range(30)] == DROPOUT_LIVE
    hists = []
    for _ in range(2):
        kernels.reset_launch_counts()
        hists.append(train_synced(error_feedback=True, steps=30, device="cuda", elastic=cfg))
        counts = kernels.launch_counts()
        assert counts["encode_fused.ef_correct_stats_2d"] == 240
        assert counts["encode_fused.codebook_encode_pack_resid_2d"] == 240
        assert counts["decode.codebook_decode_reduce_3d"] == 30 and sum(counts.values()) == 510
    hist = hists[0]
    assert hists[1] == hist
    assert abs(hist[0] - 6.4895) <= 1e-3 and abs(hist[-1] - 0.0938) <= 0.07, hist
    assert hist[-1] < hist[0] - 5.0


def _card_and_cpu(run):
    """``run("cuda")`` with its plans recorded, then ``run("cpu")`` with
    them replayed in order."""
    from repro_torch.core import codecs
    from repro_torch.core.quantizers import QuantMeta

    orig, recorded = codecs.QuantizerCodec.plan, []

    def recording(self, cfg, flat, stat):
        recorded.append(orig(self, cfg, flat, stat))
        return recorded[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codecs.QuantizerCodec, "plan", recording)
        card = run("cuda")
    replay = iter(recorded)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codecs.QuantizerCodec, "plan",
                   lambda self, cfg, flat, stat: QuantMeta(*(x.cpu() for x in next(replay))))
        cpu = run("cpu")
    assert next(replay, None) is None
    return card, cpu


def _elastic_inputs(cuda, seed: int, method: str = "tnqsgd"):
    from repro_torch.core import codecs
    from repro_torch.core.compressors import CompressorConfig, plan_buckets

    gen = torch.Generator(device=cuda).manual_seed(seed)
    leaves = [_heavy(gen, 8 * math.prod(s), cuda).reshape(8, *s) for s in SMALLNET_SHAPES]
    bp = plan_buckets([math.prod(s) for s in SMALLNET_SHAPES], int(0.02 * (1 << 20) / 4))
    sizes = codecs.bucket_state_sizes(CompressorConfig(method=method, rank=4), bp.sizes)
    ef = [_heavy(gen, 8 * m, cuda, 1e-4).reshape(8, m) for m in sizes]
    return leaves, ef, bp


@pytest.mark.parametrize("case", ["faithful", "two_phase", "hierarchical", "fp16_tier",
                                  "powersgd"])
def test_elastic_step_card_against_cpu(cuda, case):
    """One masked step on the card and on the CPU with the card's plans
    replayed: means and EF rows bitwise (powersgd's within rtol 1e-5, the
    dropped peers' residuals bitwise), each dropped peer's EF row its
    corrected bucket."""
    from repro_torch.core.compressors import CompressorConfig, bucket_concat
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig

    method = "powersgd" if case == "powersgd" else "tnqsgd"
    sync = case if case in ("two_phase", "hierarchical") else "faithful"
    dp = (2, 4) if sync == "hierarchical" else (8,)
    ts = TrainStepConfig(sync=sync, error_feedback=True, bucket_mb=0.02,
                         fp16_threshold=5000 if case == "fp16_tier" else 0,
                         compressor=CompressorConfig(method=method, bits=3, rank=4))
    leaves, ef, bp = _elastic_inputs(cuda, 21, method)
    live = torch.tensor(ELASTIC_LIVE, device=cuda)
    (mean, rows, _, _), (mean_cpu, rows_cpu, _, _) = _card_and_cpu(
        lambda dev: reference_sync_state(ts, [x.to(dev) for x in leaves], dp,
                                         prng.fold_in(prng.key(0x5EED), 0),
                                         ef=[e.to(dev) for e in ef], live=live.to(dev)))
    pairs = list(zip(mean, mean_cpu)) + list(zip(rows, rows_cpu))
    for got, want in pairs:
        if method == "powersgd":
            tol = 1e-5 * torch.abs(want) + 1e-5 * float(want.abs().max())
            assert bool((torch.abs(got.cpu() - want) <= tol).all())
        else:
            assert torch.equal(got.cpu(), want)
    for p in (0, 1, 2, 3, 5):
        for b, g in enumerate(bucket_concat([x[p] for x in leaves], bp)):
            assert torch.equal(rows[b][p][:g.numel()], g + ef[b][p][:g.numel()]), (p, b)


def test_straggler_pin_and_solo_survivor_on_the_card(cuda):
    """A dropped peer's gradient times -3.7 leaves the faithful and
    two_phase means bit for bit; with one peer live the faithful mean is
    its own decoded wire."""
    from repro_torch.core import codecs
    from repro_torch.core.compressors import CompressorConfig, bucket_concat
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig
    from repro_torch.elastic import live_mask, solo_survivor

    leaves, _, bp = _elastic_inputs(cuda, 22)
    key, live = prng.fold_in(prng.key(0x5EED), 0), torch.tensor(ELASTIC_LIVE, device=cuda)
    poked = [x.clone() for x in leaves]
    for x in poked:
        x[5] *= -3.7
    for sync in ("faithful", "two_phase"):
        ts = TrainStepConfig(sync=sync, bucket_mb=0.02, compressor=CompressorConfig(bits=3,
                                                                                    method="tnqsgd"))
        a = reference_sync_state(ts, leaves, (8,), key, live=live)[0]
        b = reference_sync_state(ts, poked, (8,), key, live=live)[0]
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))
    ts = TrainStepConfig(sync="faithful", bucket_mb=0.02, compressor=CompressorConfig(bits=3,
                                                                                      method="tnqsgd"))
    solo = live_mask(solo_survivor(8).elastic(), 0, 8, cuda)
    means = bucket_concat(reference_sync_state(ts, leaves, (8,), key, live=solo)[0], bp)
    codec = codecs.get_codec("tnqsgd")
    for b, g in enumerate(bucket_concat([x[0] for x in leaves], bp)):
        wire = codec.encode_residual(ts.compressor, g, codec.plan(ts.compressor, g, None),
                                     prng.fold_in(prng.fold_in(key, 0), b))[0]
        assert torch.equal(means[b], codec.decode_reduce(ts.compressor, wire[None], g.numel()))


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_step_card_against_cpu(cuda, masked):
    """Faithful tnqsgd with EF and ``metrics_compression``, the plans
    replayed: every metric but ``predicted_mse`` bitwise, that within rtol
    1e-3 (each device bins by its own log)."""
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig

    ts = TrainStepConfig(sync="faithful", error_feedback=True, bucket_mb=0.02,
                         metrics_compression=True, compressor=CompressorConfig(bits=3))
    leaves, ef, bp = _elastic_inputs(cuda, 23)
    live = torch.tensor(ELASTIC_LIVE, device=cuda) if masked else None
    (_, _, _, cm), (_, _, _, cm_cpu) = _card_and_cpu(
        lambda dev: reference_sync_state(ts, [x.to(dev) for x in leaves], (8,),
                                         prng.fold_in(prng.key(0x5EED), 0),
                                         ef=[e.to(dev) for e in ef],
                                         live=None if live is None else live.to(dev)))
    for f in cm._fields:
        got, want = getattr(cm, f).cpu(), getattr(cm_cpu, f)
        assert got.shape == (8, bp.n_buckets), f
        if f == "predicted_mse":
            assert bool((torch.abs(got - want) <= 1e-3 * torch.abs(want)).all())
        else:
            assert torch.equal(got, want), f


# -- the mesh sync: 2 gloo ranks on cuda:0 --------------------------------

MESH_MODES = {"faithful": (2,), "two_phase": (2,), "hierarchical": (1, 2), "dsgd": (2,)}
MESH_SHAPES = [(64, 48), (37, 61), (2048,), (999,)]


def _mesh_gpu_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank: a sync per mode of ``MESH_MODES`` (tnqsgd, 3 bits, EF on but
    for dsgd) on cuda:0 against the card replay this rank computes itself;
    writes ``{mode: {ok, error, digest, counts}}``."""
    import hashlib
    import json
    import os
    import traceback

    from repro_torch.core.codecs import bucket_state_sizes
    from repro_torch.core.compressors import CompressorConfig, plan_buckets
    from repro_torch.dist import compat
    from repro_torch.dist.reference import reference_sync_state
    from repro_torch.dist.train_step import TrainStepConfig, make_sync_fn
    from repro_torch.train import _float32_and_deterministic

    torch.set_num_threads(1)
    _float32_and_deterministic()
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank,
                                         world_size=world)
    try:
        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(7)
        leaves = [_heavy(gen, world * math.prod(s), dev).reshape(world, *s)
                  for s in MESH_SHAPES]
        meshes = {dp: compat.Mesh(dp) for dp in sorted(set(MESH_MODES.values()))}
        report = {}
        for mode, dp in MESH_MODES.items():
            try:
                ts = TrainStepConfig(sync=mode, bucket_mb=1.0 / 64.0, error_feedback=mode != "dsgd",
                                     compressor=CompressorConfig(method="tnqsgd", bits=3),
                                     metrics_gnorm=False)
                bp = plan_buckets([math.prod(s) for s in MESH_SHAPES], ts.bucket_elements)
                ef = [_heavy(gen, world * m, dev, 1e-4).reshape(world, m)
                      for m in bucket_state_sizes(ts.compressor, bp.sizes)]
                key = prng.fold_in(prng.key(0x5EED), 3)
                args = [[x[rank] for x in leaves], key]
                if ts.error_feedback:
                    args.append(tuple(e[rank] for e in ef))
                kernels.reset_launch_counts()
                out = make_sync_fn(ts, meshes[dp], args[0])(*args)
                torch.cuda.synchronize()
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
                mean = out[0] if ts.error_feedback else out
                w_mean, w_res, _, _ = reference_sync_state(
                    ts, leaves, dp, key, ef=ef if ts.error_feedback else None)
                for a, b in zip(mean, w_mean, strict=True):
                    assert a.device == dev
                    if mode == "dsgd":
                        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
                            b.abs().max()))
                    else:
                        assert torch.equal(a, b), "mean differs from the card replay"
                if ts.error_feedback:
                    for b_, e in enumerate(out[1]):
                        assert torch.equal(e, w_res[b_][rank]), f"EF row {b_}"
                h = hashlib.sha256()
                for m in mean:
                    h.update(m.cpu().numpy().tobytes())
                report[mode] = {"ok": True, "digest": h.hexdigest(), "counts": counts}
            except Exception:  # report the mode's failure and go on
                report[mode] = {"ok": False, "error": traceback.format_exc()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_gpu_reports(tmp_path_factory):
    import json

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    tmp = tmp_path_factory.mktemp("mesh_gpu")
    torch.multiprocessing.start_processes(_mesh_gpu_rank, args=(2, f"file://{tmp}/rdzv", str(tmp)),
                                          nprocs=2, join=True, start_method="spawn")
    return [json.load(open(tmp / f"rank{r}.json")) for r in range(2)]


@pytest.mark.parametrize("mode", list(MESH_MODES))
def test_mesh_sync_on_two_ranks_is_the_card_replay(mesh_gpu_reports, mode):
    """Two gloo ranks on cuda:0 (hierarchical as one pod of 2): every
    rank's means bitwise the other's and the card replay's (dsgd within
    1e-6), its EF rows bitwise its replay rows, and the mode's kernels
    launched on the card."""
    reports = [r[mode] for r in mesh_gpu_reports]
    for rank, rec in enumerate(reports):
        assert rec["ok"], f"rank {rank}:\n{rec['error']}"
    assert reports[0]["digest"] == reports[1]["digest"]
    if mode != "dsgd":
        assert reports[0]["counts"] == reports[1]["counts"]
        assert reports[0]["counts"].get("decode.codebook_decode_reduce_3d", 0) >= 1
        assert reports[0]["counts"].get("encode_fused.ef_correct_stats_2d", 0) == 3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-2b", "whisper-base"])
def test_reduced_serving_card_against_cpu(cuda, arch):
    """The reduced arch served on the card (float32, TF32 off) against the
    same weights and batch on the CPU: the prefill logits and 4 decode
    steps within rtol 1e-4 / atol 1e-4 x max |logit|, the greedy tokens
    equal, and no port kernel launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist.serve_step import make_serve_fns
    from repro_torch.models import transformer
    from repro_torch.train import _float32_and_deterministic

    _float32_and_deterministic()
    cfg = reduced(get_config(arch))
    params = transformer.init_lm(prng.key(0), cfg, device="cpu")
    batch = lm_batch(cfg, 0, 2, 32, device="cpu")
    prefill_fn, decode_fn = make_serve_fns(cfg, 32)
    counts = kernels.launch_counts()

    def serve(device):
        p = _tree_to(params, device)
        b = transformer.Batch(*(None if x is None else x.to(device) for x in batch))
        logits, caches = prefill_fn(p, b)
        out, toks = [logits.cpu()], []
        for i in range(4):
            toks.append(logits.argmax(-1)[:, None])
            logits, caches = decode_fn(p, toks[-1], caches, 32 + i)
            out.append(logits.cpu())
        return torch.stack(out), torch.cat(toks, 1).cpu()

    got, got_toks = serve(cuda)
    want, want_toks = serve("cpu")
    assert torch.equal(got_toks, want_toks)
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-4 * want.abs()).all())
    assert kernels.launch_counts() == counts


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen3-moe-235b-a22b"])
def test_reduced_moe_and_hybrid_served_twice_bitwise(cuda, arch):
    """A reduced jamba superblock and a reduced qwen3-moe at 16 experts top-8
    (the sort-based dispatch and its fixed-order combine) served twice on
    the card: the logits and tokens of prefill and 4 decode steps bit for
    bit, within rtol 1e-4 / atol 1e-4 x max |logit| of the CPU's, and no
    port kernel launched."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist.serve_step import make_serve_fns
    from repro_torch.models import transformer
    from repro_torch.train import _float32_and_deterministic

    _float32_and_deterministic()
    cfg = reduced(get_config(arch))
    if cfg.family == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=8))
    params = transformer.init_lm(prng.key(0), cfg, device="cpu")
    batch = lm_batch(cfg, 0, 4, 64, device="cpu")
    prefill_fn, decode_fn = make_serve_fns(cfg, 64)
    counts = kernels.launch_counts()

    def serve(device):
        p = _tree_to(params, device)
        b = transformer.Batch(*(None if x is None else x.to(device) for x in batch))
        logits, caches = prefill_fn(p, b)
        out, toks = [logits.cpu()], []
        for i in range(4):
            toks.append(logits.argmax(-1)[:, None])
            logits, caches = decode_fn(p, toks[-1], caches, 64 + i)
            out.append(logits.cpu())
        return torch.stack(out), torch.cat(toks, 1).cpu()

    first, second = serve(cuda), serve(cuda)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    want, want_toks = serve("cpu")
    assert torch.equal(first[1], want_toks)
    scale = float(want.abs().max())
    assert bool(((first[0] - want).abs() <= 1e-4 * scale + 1e-4 * want.abs()).all())
    assert kernels.launch_counts() == counts


def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_span_recorder_times_the_card(cuda):
    """A span synchronized on the card lasts at least the CUDA-event time of
    the work queued inside it (an unsynchronized host clock would see only
    the enqueue)."""
    from repro_torch.obs import SpanRecorder

    gen = torch.Generator(device=cuda).manual_seed(0)
    g2 = ops._to_2d(_heavy(gen, 1 << 24, cuda))[0]
    stats.bucket_stats_2d(g2, 1 << 24)
    rec = SpanRecorder(device=cuda)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with rec.span("stats", step=0):
        start.record()
        for _ in range(50):
            stats.bucket_stats_2d(g2, 1 << 24)
        end.record()
    end.synchronize()
    span = rec.summary()["stats"]
    assert span["count"] == 1 and span["max_s"] >= start.elapsed_time(end) / 1e3 > 0


def test_dry_run_allocates_nothing_and_kernels_pass_is_clean(cuda):
    """The dry run (llama3.2-1b's published config, meta tensors) takes no
    card memory and launches no port kernel; the kernels pass over this
    build's ptxas reports finds every K1-K17 and no spill, no shared memory
    or registers past the card's limits."""
    import gc

    from repro_torch.analysis import kernel_resources
    from repro_torch.launch import dryrun

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, counts = torch.cuda.memory_allocated(), kernels.launch_counts()
    rec = dryrun.run_one("llama3.2-1b", dryrun.shape_for("train_4k", 4, 2048), ef=True,
                         optimizer="momentum_sgd")
    assert torch.cuda.memory_allocated() == before == torch.cuda.max_memory_allocated()
    assert kernels.launch_counts() == counts
    assert rec["roofline"]["flops"] > rec["roofline"]["model_flops"] > 0
    findings, table = kernel_resources.run_pass()
    assert findings == [], [str(f) for f in findings]
    assert all(row["entries"] for row in kernel_resources.per_kernel(table).values())


# -- the model axis: 2 gloo ranks on cuda:0 ---------------------------------


def _tp_gpu_rank(rank: int, world: int, init: str, out_dir: str) -> None:
    """One rank of a (data, model) = (1, 2) mesh: the reduced llama's train
    step (faithful tnqsgd, 3 bits, EF) twice from the same state, 2 steps
    each; writes both runs' losses, gnorms, params and EF rows and the
    launches of the first."""
    import os

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.compressors import CompressorConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist import compat, sharding
    from repro_torch.dist.train_step import TrainStepConfig, init_ef_state, make_train_step
    from repro_torch.models.smallnet import tree_leaves
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.optimizers import momentum_sgd
    from repro_torch.train import _float32_and_deterministic

    torch.set_num_threads(1)
    _float32_and_deterministic()
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        mesh = compat.Mesh((1, 2), ("data", "model"))
        cfg = reduced(get_config("llama3.2-1b"))
        params = sharding.shard_tree(init_lm(prng.key(0), cfg, device=dev),
                                     sharding.lm_pspecs(cfg, mesh), mesh)
        ts = TrainStepConfig(sync="faithful", error_feedback=True,
                             compressor=CompressorConfig(method="tnqsgd", bits=3))
        opt = momentum_sgd(lr=0.05)
        batches = [lm_batch(cfg, i, 2, 64, dev) for i in range(2)]
        fn = make_train_step(cfg, mesh, opt, ts, batches[0], params_like=params)
        runs = []
        for _ in range(2):
            kernels.reset_launch_counts()
            p, o, ef, hist = params, opt.init(params), init_ef_state(params, ts), []
            for i, b in enumerate(batches):
                p, o, ef, m = fn(p, o, ef, b, i)
                hist.append((float(m["loss"][0]), float(m["gnorm"][0])))
            runs.append({"hist": hist, "params": [t.cpu() for t in tree_leaves(p)],
                         "ef": [e.cpu() for e in ef],
                         "counts": {k: v for k, v in kernels.launch_counts().items() if v}})
        torch.save(runs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_model_axis_step_on_two_ranks_repeats_bitwise(cuda, tmp_path):
    """The reduced llama on a (1, 2) data x model mesh, 2 gloo ranks on
    cuda:0: each rank's two runs are bitwise alike (losses, gnorms, its
    params and EF rows), both model ranks report the same loss, the loss
    is finite, and each rank launches K1, K2 and K4 once a bucket a step."""
    torch.multiprocessing.start_processes(_tp_gpu_rank, args=(2, f"file://{tmp_path}/rdzv",
                                                              str(tmp_path)),
                                          nprocs=2, join=True, start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for runs in ranks:
        first, second = runs
        assert first["hist"] == second["hist"]
        assert all(torch.equal(a, b) for a, b in zip(first["params"], second["params"]))
        assert all(torch.equal(a, b) for a, b in zip(first["ef"], second["ef"]))
        assert all(math.isfinite(x) for h in first["hist"] for x in h)
        n_buckets = len(first["ef"])
        assert first["counts"] == {
            "encode_fused.ef_correct_stats_2d": 2 * n_buckets,
            "encode_fused.codebook_encode_pack_resid_2d": 2 * n_buckets,
            "decode.codebook_decode_reduce_3d": 2 * n_buckets}
    assert [h[0] for h in ranks[0][0]["hist"]] == [h[0] for h in ranks[1][0]["hist"]]
