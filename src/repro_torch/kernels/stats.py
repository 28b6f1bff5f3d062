"""Bucket-statistics kernel (K10) and the statistics-tile constants.

The port of ``repro.kernels.stats``: one pass over a flat fp32 bucket (in
the (rows, 128) layout, or as it lies) gives the (STATS_ROWS, NUM_BINS)
tile that ``core.compressors.plan_from_stats`` fits the tail and codebook
from — row 0 counts of a 128-bin log2-spaced |g| histogram (bin 0 catches
underflow and zeros, bin 127 overflow), row 1 per-bin sums of ln|g|, row
2 max |g|, row 3 sum g, row 4 sum g².  The kernel is ``csrc/stats.cu``;
its plain PyTorch version is ``kernels.ref.bucket_stats``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LANES = 128
BLOCK_ROWS = 64          # rows per Pallas statistics tile (and the plain version's)
NUM_BINS = 128           # == LANES so one output row holds the histogram
LOG2_LO = -24.0          # |g| below 2^-24 (incl. zeros) lands in bin 0
LOG2_HI = 8.0            # |g| above 2^8 lands in bin NUM_BINS-1
STATS_ROWS = 8           # output tile rows (5 used)


def bin_edges(device=None) -> torch.Tensor:
    """(NUM_BINS+1,) |g| bin edges: edges[0]=0, edges[k]=2^(LO+k·w) else."""
    w = (LOG2_HI - LOG2_LO) / NUM_BINS
    e = torch.exp2(LOG2_LO + w * torch.arange(NUM_BINS + 1, dtype=torch.float32, device=device))
    e[0] = 0.0
    return e


def check_2d(name: str, x: torch.Tensor, dtype=torch.float32, cols: int = LANES) -> None:
    """Raise unless ``x`` is a contiguous CUDA (rows, cols) tensor of ``dtype``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {x.device}")
    if x.dtype != dtype or x.dim() != 2 or x.shape[1] != cols or x.shape[0] < 1:
        raise ValueError(f"{name} must be a non-empty (rows, {cols}) {dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_flat(name: str, x: torch.Tensor, numel: int | None = None) -> None:
    """Raise unless ``x`` is a contiguous non-empty fp32 CUDA tensor (of
    ``numel`` elements where given); its shape and alignment are free."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.float32 or x.numel() < 1 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous non-empty float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"{name} has {x.numel()} elements, expected {numel}")


def tile_and_scratch(elements: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One allocation for the statistics kernels over a buffer of
    ``elements``: the (STATS_ROWS, NUM_BINS) output tile, and the scratch
    behind it (device-wide accumulators, zeroed by the launch, and one
    partial pair per block)."""
    words = _build.bind("stats", "repro_stats_scratch_words", [ctypes.c_longlong])(elements)
    buf = torch.empty(STATS_ROWS * NUM_BINS + words, dtype=torch.float32, device=device)
    return buf[:STATS_ROWS * NUM_BINS].view(STATS_ROWS, NUM_BINS), buf[STATS_ROWS * NUM_BINS:]


def bucket_stats_2d(g2: torch.Tensor, n: int) -> torch.Tensor:
    """K10: (rows, 128) fp32 CUDA bucket, n true elements ->
    (STATS_ROWS, NUM_BINS) fp32 statistics tile."""
    check_2d("g", g2)
    return bucket_stats_flat(g2, n)


def bucket_stats_flat(g: torch.Tensor, n: int) -> torch.Tensor:
    """K10 on a contiguous fp32 CUDA buffer as it lies (no padding, any
    alignment): the statistics tile of its first n elements.  A launch of
    K10, counted in ``bucket_stats_2d.launches``."""
    check_flat("g", g)
    if not 1 <= n <= g.numel():
        raise ValueError(f"n={n} outside [1, {g.numel()}]")
    fn = _build.bind("stats", "repro_bucket_stats", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p])
    out, work = tile_and_scratch(n, g.device)
    with torch.cuda.device(g.device):
        code = fn(_build.ptr(g), _build.ptr(work), _build.ptr(out), n, _build.stream(g))
    _build.check(code, "bucket_stats_2d")
    bucket_stats_2d.launches += 1
    return out


bucket_stats_2d.launches = 0
