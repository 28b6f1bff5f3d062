"""Fused unpack → codebook dequant → peer-mean kernel (K4).

The port of ``repro.kernels.decode``'s codebook reduce: every peer's packed
wire rows plus that peer's codebook in, the (rows, 128) fp32 peer mean out,
without materializing the (peers, n) code tensor (``csrc/decode.cu``).  The
peers are summed in order and divided once by their count, which makes the
kernel bit-exact against ``kernels.ref.codebook_decode_reduce``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import LANES


def words_per_row(bits: int) -> int:
    """uint32 wire words per (128,) element row: 4 groups of 32 × bit-planes."""
    return (LANES // 32) * bits


def codebook_decode_reduce_3d(words3: torch.Tensor, levels2: torch.Tensor, bits: int):
    """K4: words (peers, rows, 4·bits) int32 CUDA, levels (peers, s+1) fp32
    -> (rows, 128) fp32 peer mean."""
    if words3.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got one on {words3.device}")
    if (words3.dtype != torch.int32 or words3.dim() != 3 or words3.shape[1] < 1
            or words3.shape[2] != words_per_row(bits) or not words3.is_contiguous()):
        raise ValueError(f"words must be a contiguous (peers, rows, {words_per_row(bits)}) "
                         f"int32 tensor, got {tuple(words3.shape)} {words3.dtype}")
    peers = words3.shape[0]
    if (levels2.shape != (peers, 2**bits) or levels2.dtype != torch.float32
            or levels2.device != words3.device or not levels2.is_contiguous()):
        raise ValueError(f"levels must be a contiguous ({peers}, {2**bits}) fp32 tensor "
                         f"on {words3.device}, got {tuple(levels2.shape)} {levels2.dtype}")
    fn = _build.bind("decode", "repro_codebook_decode_reduce", [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    rows = words3.shape[1]
    out = torch.empty((rows, LANES), dtype=torch.float32, device=words3.device)
    with torch.cuda.device(words3.device):
        code = fn(_build.ptr(words3), _build.ptr(levels2), peers, 2**bits - 1, bits, rows,
                  _build.ptr(out), _build.stream(words3))
    _build.check(code, "codebook_decode_reduce_3d")
    codebook_decode_reduce_3d.launches += 1
    return out


codebook_decode_reduce_3d.launches = 0
