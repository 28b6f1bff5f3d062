"""Plain PyTorch versions of the port's kernels.

Each function takes exactly the operands of its kernel — the padded
(rows, 128) bucket, the true element count n, and the explicit uniform draw
``rand`` where the kernel rounds stochastically — and returns what the
kernel returns.  They are the CPU path of ``kernels.ops`` and the card's
oracle: on the card, ``chip_smoke.py`` and the ``gpu`` tests hold every
kernel against them on identical inputs.

Divisions by a constant divide by a 0-dim tensor on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the IEEE quotient the kernels and the JAX package compute.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantizers import pack_codes, unpack_codes

from . import stats as S


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def bucket_stats(g2: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, 128) fp32 bucket, n true elements -> (STATS_ROWS, NUM_BINS)
    statistics tile, walking the kernel's 64-row tiles and merging their
    partials in tile order (``stats._block_stats`` / ``stats._merge``).

    Counts and max are exact; the ln and moment sums are taken in another
    order than the kernel's, so they agree to float32 rounding.
    """
    flat = g2.reshape(-1).to(torch.float32)
    m = S.BLOCK_ROWS * S.LANES
    blocks = -(-flat.numel() // m)
    x = torch.zeros(blocks * m, dtype=torch.float32, device=flat.device)
    x[:flat.numel()] = flat
    valid = torch.arange(blocks * m, device=flat.device) < n
    vmask = valid.to(torch.float32)
    gabs = torch.abs(x) * vmask
    lnab = torch.log(torch.clamp_min(gabs, 1e-30))
    w = (S.LOG2_HI - S.LOG2_LO) / S.NUM_BINS
    b = torch.floor((_div(lnab, float(math.log(2.0))) - S.LOG2_LO) / w)
    b = torch.clamp(b, 0.0, S.NUM_BINS - 1.0).to(torch.int64)
    # invalid elements go to a spare bin NUM_BINS that is dropped
    b = torch.where(valid, b, S.NUM_BINS)
    slot = torch.arange(blocks, device=flat.device).repeat_interleave(m) * (S.NUM_BINS + 1) + b
    hist = torch.zeros(blocks * (S.NUM_BINS + 1), dtype=torch.float32, device=flat.device)
    counts = hist.index_add(0, slot, vmask).reshape(blocks, -1)[:, :S.NUM_BINS]
    logsum = hist.index_add(0, slot, lnab * vmask).reshape(blocks, -1)[:, :S.NUM_BINS]
    gv = (x * vmask).reshape(blocks, m)
    part = torch.zeros((blocks, S.STATS_ROWS, S.NUM_BINS), dtype=torch.float32, device=flat.device)
    part[:, 0] = counts
    part[:, 1] = logsum
    part[:, 2] = gabs.reshape(blocks, m).amax(1, keepdim=True)
    part[:, 3] = gv.sum(1, keepdim=True)
    part[:, 4] = (gv * gv).sum(1, keepdim=True)
    acc = torch.zeros((S.STATS_ROWS, S.NUM_BINS), dtype=torch.float32, device=flat.device)
    for i in range(blocks):
        nxt = acc + part[i]
        nxt[2] = torch.maximum(acc[2], part[i, 2])
        acc = nxt
    return acc


def ef_correct_stats(g2: torch.Tensor, e2: torch.Tensor, n: int):
    """``c = g + e`` plus the statistics tile of c's first n elements."""
    c2 = g2 + e2
    return c2, bucket_stats(c2, n)


def codebook_encode_pack_residual(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                                  n: int, bits: int):
    """(rows, 128) bucket + (rows, 128) uniforms + (s+1,) codebook ->
    ((rows, 4·bits) int32 wire words, (rows, 128) residual ``g − levels[code]``).

    The interval index comes from a binary search, which equals the
    kernel's compare-count ``#(clip(g) >= levels[1:])`` clamped to [0, s−1]:
    clipping puts every value at or above levels[0].  Codes past n are zero.
    """
    s = levels.shape[0] - 1
    alpha = levels[s]
    gt = torch.minimum(torch.maximum(g2, -alpha), alpha)
    k = torch.searchsorted(levels, gt.reshape(-1), right=True).reshape(gt.shape) - 1
    k = torch.clamp(k, 0, s - 1)
    lo, hi = levels[k], levels[k + 1]
    pr = (gt - lo) / torch.clamp_min(hi - lo, 1e-12)
    up = rand < pr
    resid = g2 - torch.where(up, hi, lo)
    codes = (k + up.to(k.dtype)).reshape(-1)
    codes[n:] = 0
    return pack_codes(codes, bits).reshape(g2.shape[0], -1), resid


def codebook_decode_reduce(words3: torch.Tensor, levels2: torch.Tensor, bits: int) -> torch.Tensor:
    """(peers, rows, 4·bits) wire words + (peers, s+1) codebooks ->
    (rows, 128) mean over peers of ``levels_p[code]``: the peers are added
    in order, then divided once by their count."""
    peers, rows, _ = words3.shape
    acc = torch.zeros(rows * S.LANES, dtype=torch.float32, device=words3.device)
    for p in range(peers):
        codes = unpack_codes(words3[p].reshape(-1), rows * S.LANES, bits).to(torch.int64)
        acc = acc + levels2[p][codes]
    return _div(acc, float(peers)).reshape(rows, S.LANES)
