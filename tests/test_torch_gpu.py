"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU, ``nvcc`` and no JAX; every test is marked ``gpu`` and
skips without a card.  Run them on the card with
``python3 -m pytest -q -m gpu tests/test_torch_gpu.py``.

Contract: K2, K3, K6, K7 words and residuals and K4, K5, K8, K9 outputs
bitwise (the kernels are built with ``-fmad=false`` and IEEE division, so
the uniform dequant rounds as the plain version's separate ops do); K1/K10
counts and max exact, the ln and moment sums within rtol 1e-5 (of each
bin's sum, and of Σ|x| for the signed sum), and bitwise equal across two
launches; K11 within rtol 1e-5 / atol 1e-6 of its plain version (the
sums run in another order), exact zeros for zero columns, and bitwise
equal across two launches.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import decode, encode_fused, ops, orthogonalize, ref, stats  # noqa: E402

pytestmark = pytest.mark.gpu
SIZES = [999, 64 * 128 * 2 + 17, 70_000]
RTOL = 1e-5
# tests/test_lowrank.py's shapes, then smallnet's and a full 4 MB bucket's P
# factor (809 and 1,024 rows) at rank 4, the rank cap 64 and rank 1
GS_SHAPES = [(8, 4), (128, 8), (1000, 3), (7, 7), (513, 16), (809, 4), (1024, 4), (1024, 64),
             (809, 1)]


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
    assert kernels.launch_counts() == {k.__name__: 1 for k in kernels.KERNELS}
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


@pytest.mark.parametrize("shape", GS_SHAPES)
def test_orthogonalize_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(shape[0] * 100 + shape[1])
    p = torch.randn(*shape, generator=gen, device=cuda)
    out = orthogonalize.orthogonalize_2d(p)
    assert torch.equal(orthogonalize.orthogonalize_2d(p), out)
    torch.testing.assert_close(out, ref.orthogonalize(p), rtol=RTOL, atol=1e-6)


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
    assert kernels.launch_counts()["orthogonalize_2d"] == 1
    for bad in (torch.zeros((16, 65), device=cuda),                       # rank above 64
                torch.zeros((16, 0), device=cuda),                        # rank 0
                torch.zeros((0, 4), device=cuda),                         # no rows
                torch.zeros(16, device=cuda),                             # not 2-D
                torch.zeros((16, 4), device=cuda).double(),               # dtype
                torch.zeros((4, 16), device=cuda).T,                      # not contiguous
                torch.zeros((16, 4))):                                    # not on the card
        with pytest.raises(ValueError):
            orthogonalize.orthogonalize_2d(bad)
    assert kernels.launch_counts()["orthogonalize_2d"] == 1


def test_synced_training_runs_through_the_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(error_feedback=True, steps=2, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 2 and all(h == h for h in hist)
    assert counts["ef_correct_stats_2d"] == 16 and counts["codebook_encode_pack_resid_2d"] == 16
    assert counts["codebook_decode_reduce_3d"] == 2 and counts["bucket_stats_2d"] == 0


def test_two_phase_tqsgd_runs_through_the_uniform_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(sync="two_phase", method="tqsgd", steps=1, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 1 and hist[0] == hist[0]
    assert counts["uniform_encode_pack_resid_2d"] == 8 and counts["uniform_decode_reduce_3d"] == 8
    assert counts["uniform_encode_pack_2d"] == 8 and counts["uniform_decode_rows_3d"] == 1
    assert counts["bucket_stats_2d"] == 16


def test_powersgd_training_runs_through_k11(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(method="powersgd", error_feedback=True, steps=2, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 2 and all(h == h for h in hist)
    assert counts["ef_correct_stats_2d"] == 16 and counts["orthogonalize_2d"] == 16
    assert sum(counts.values()) == 32
