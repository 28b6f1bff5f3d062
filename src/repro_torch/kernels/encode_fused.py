"""Fused encode-side kernels: EF-correct→stats (K1) and codebook
quantize→pack→residual (K2).

The port of ``repro.kernels.encode_fused``.  ``ef_correct_stats_2d`` reads a
gradient bucket and its EF residual once, writes ``c = g + e`` and the
statistics tile of c (``csrc/stats.cu`` with the EF add compiled in).
``codebook_encode_pack_resid_2d`` rounds c stochastically onto the bucket's
codebook, packs the codes into the wire words and writes the next EF
residual ``c − levels[code]`` in the same pass (``csrc/encode_fused.cu``).
Both take CUDA tensors only; their plain PyTorch versions are in
``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import LANES, NUM_BINS, STATS_ROWS, check_2d, partials


def ef_correct_stats_2d(g2: torch.Tensor, e2: torch.Tensor, n: int):
    """K1: g, e (rows, 128) fp32 CUDA, n true elements ->
    ((rows, 128) corrected c, (STATS_ROWS, NUM_BINS) stats tile of c)."""
    check_2d("g", g2)
    check_2d("e", e2)
    if e2.shape != g2.shape or e2.device != g2.device:
        raise ValueError(f"e {tuple(e2.shape)} on {e2.device} must match g "
                         f"{tuple(g2.shape)} on {g2.device}")
    if not 1 <= n <= g2.numel():
        raise ValueError(f"n={n} outside [1, {g2.numel()}]")
    fn = _build.bind("stats", "repro_ef_correct_stats", [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    c2 = torch.empty_like(g2)
    scratch = partials(g2)
    out = torch.empty((STATS_ROWS, NUM_BINS), dtype=torch.float32, device=g2.device)
    with torch.cuda.device(g2.device):
        code = fn(_build.ptr(g2), _build.ptr(e2), _build.ptr(c2), _build.ptr(scratch),
                  _build.ptr(out), n, g2.shape[0], _build.stream(g2))
    _build.check(code, "ef_correct_stats_2d")
    ef_correct_stats_2d.launches += 1
    return c2, out


ef_correct_stats_2d.launches = 0


def codebook_encode_pack_resid_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                                  n: int, bits: int):
    """K2: g, rand (rows, 128) fp32 CUDA, levels (s+1,) fp32 ->
    ((rows, 4·bits) int32 wire words, (rows, 128) fp32 residual)."""
    check_2d("g", g2)
    check_2d("rand", rand)
    s = levels.shape[0] - 1 if levels.dim() == 1 else -1
    if rand.shape != g2.shape or rand.device != g2.device:
        raise ValueError("rand must match g in shape and device")
    if (levels.device != g2.device or levels.dtype != torch.float32
            or not levels.is_contiguous() or s != 2**bits - 1):
        raise ValueError(f"levels must be a contiguous ({2**bits},) fp32 tensor on "
                         f"{g2.device} for bits={bits}, got {tuple(levels.shape)} "
                         f"{levels.dtype} on {levels.device}")
    if not 1 <= n <= g2.numel():
        raise ValueError(f"n={n} outside [1, {g2.numel()}]")
    fn = _build.bind("encode_fused", "repro_codebook_encode_pack_resid", [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    rows = g2.shape[0]
    words = torch.empty((rows, (LANES // 32) * bits), dtype=torch.int32, device=g2.device)
    resid = torch.empty_like(g2)
    with torch.cuda.device(g2.device):
        code = fn(_build.ptr(g2), _build.ptr(rand), _build.ptr(levels), s, bits, n, rows,
                  _build.ptr(words), _build.ptr(resid), _build.stream(g2))
    _build.check(code, "codebook_encode_pack_resid_2d")
    codebook_encode_pack_resid_2d.launches += 1
    return words, resid


codebook_encode_pack_resid_2d.launches = 0
