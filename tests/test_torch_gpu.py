"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU, ``nvcc`` and no JAX; every test is marked ``gpu`` and
skips without a card.  Run them on the card with
``python3 -m pytest -q -m gpu tests/test_torch_gpu.py``.

Contract: K2 words and residual and K4 means bitwise; K1/K10 counts and max
exact, the ln and moment sums within rtol 1e-5 (of each bin's sum, and of
Σ|x| for the signed sum), and bitwise equal across two launches.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import decode, encode_fused, ops, ref, stats  # noqa: E402

pytestmark = pytest.mark.gpu
SIZES = [999, 64 * 128 * 2 + 17, 70_000]
RTOL = 1e-5


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


def test_wrappers_count_launches_and_reject_bad_operands(cuda):
    kernels.reset_launch_counts()
    g = torch.randn(5000, device=cuda)
    ops.bucket_stats(g)
    ops.ef_correct_stats(g, g)
    words, _ = ops.codebook_encode_pack_residual(g, torch.linspace(-1, 1, 8, device=cuda), 3,
                                                 prng.key(0))
    ops.codebook_decode_reduce(words[None], torch.linspace(-1, 1, 8, device=cuda)[None], 5000, 3)
    assert kernels.launch_counts() == {"ef_correct_stats_2d": 1, "bucket_stats_2d": 1,
                                       "codebook_encode_pack_resid_2d": 1,
                                       "codebook_decode_reduce_3d": 1}
    with pytest.raises(ValueError):
        stats.bucket_stats_2d(torch.zeros((4, 64), device=cuda), 10)
    with pytest.raises(ValueError):
        encode_fused.codebook_encode_pack_resid_2d(
            torch.zeros((4, 128), device=cuda), torch.zeros((4, 128), device=cuda),
            torch.zeros(4, device=cuda), 10, 3)


def test_synced_training_runs_through_the_kernels(cuda):
    from repro_torch.train import train_synced

    kernels.reset_launch_counts()
    hist = train_synced(error_feedback=True, steps=2, device="cuda")
    counts = kernels.launch_counts()
    assert len(hist) == 2 and all(h == h for h in hist)
    assert counts["ef_correct_stats_2d"] == 16 and counts["codebook_encode_pack_resid_2d"] == 16
    assert counts["codebook_decode_reduce_3d"] == 2 and counts["bucket_stats_2d"] == 0
