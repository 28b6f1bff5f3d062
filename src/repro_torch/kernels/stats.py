"""Bucket-statistics kernel (K10) and the statistics-tile constants.

The port of ``repro.kernels.stats``: one pass over a flat fp32 bucket in the
(rows, 128) layout gives the (STATS_ROWS, NUM_BINS) tile that
``core.compressors.plan_from_stats`` fits the tail and codebook from — row 0
counts of a 128-bin log2-spaced |g| histogram (bin 0 catches underflow and
zeros, bin 127 overflow), row 1 per-bin sums of ln|g|, row 2 max |g|,
row 3 sum g, row 4 sum g².  The kernel is ``csrc/stats.cu``; its plain
PyTorch version is ``kernels.ref.bucket_stats``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LANES = 128
BLOCK_ROWS = 64          # rows per statistics tile: 8192 elements
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


def partials(g2: torch.Tensor) -> torch.Tensor:
    """Per-tile scratch of the two-pass statistics kernels."""
    tiles = -(-g2.shape[0] // BLOCK_ROWS)
    return torch.empty((tiles, STATS_ROWS, NUM_BINS), dtype=torch.float32, device=g2.device)


def bucket_stats_2d(g2: torch.Tensor, n: int) -> torch.Tensor:
    """K10: (rows, 128) fp32 CUDA bucket, n true elements ->
    (STATS_ROWS, NUM_BINS) fp32 statistics tile."""
    check_2d("g", g2)
    if not 1 <= n <= g2.numel():
        raise ValueError(f"n={n} outside [1, {g2.numel()}]")
    fn = _build.bind("stats", "repro_bucket_stats", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    scratch = partials(g2)
    out = torch.empty((STATS_ROWS, NUM_BINS), dtype=torch.float32, device=g2.device)
    with torch.cuda.device(g2.device):
        code = fn(_build.ptr(g2), _build.ptr(scratch), _build.ptr(out), n, g2.shape[0],
                  _build.stream(g2))
    _build.check(code, "bucket_stats_2d")
    bucket_stats_2d.launches += 1
    return out


bucket_stats_2d.launches = 0
