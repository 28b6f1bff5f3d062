"""Fused unpack → dequant → peer-mean (or per-peer) kernels: K4, K5, K8, K9.

The port of ``repro.kernels.decode``: every peer's packed wire rows plus
that peer's codebook (or its α, for the uniform methods) in, and either the
(rows, 128) fp32 peer mean (``*_reduce_3d``) or one (rows, 128) band per
peer (``*_rows_3d``, the all-gather phase-2 sites) out, without
materializing the (peers, n) code tensor (``csrc/decode.cu``).  The peers
are summed in order and divided once by their count, which makes the
reductions bit-exact against their plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import LANES


def words_per_row(bits: int) -> int:
    """uint32 wire words per (128,) element row: 4 groups of 32 × bit-planes."""
    return (LANES // 32) * bits


def _check(words3: torch.Tensor, meta: torch.Tensor, bits: int, uniform: bool) -> None:
    if words3.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got one on {words3.device}")
    if (words3.dtype != torch.int32 or words3.dim() != 3 or words3.shape[1] < 1
            or words3.shape[2] != words_per_row(bits) or not words3.is_contiguous()):
        raise ValueError(f"words must be a contiguous (peers, rows, {words_per_row(bits)}) "
                         f"int32 tensor, got {tuple(words3.shape)} {words3.dtype}")
    peers = words3.shape[0]
    shape = (peers,) if uniform else (peers, 2**bits)
    what = "alphas" if uniform else "levels"
    if (meta.shape != shape or meta.dtype != torch.float32
            or meta.device != words3.device or not meta.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {shape} fp32 tensor "
                         f"on {words3.device}, got {tuple(meta.shape)} {meta.dtype}")


def _launch(kernel, fn_name: str, words3: torch.Tensor, meta: torch.Tensor, bits: int,
            uniform: bool, reduce: bool) -> torch.Tensor:
    _check(words3, meta, bits, uniform)
    fn = _build.bind("decode", fn_name, [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p])
    peers, rows, _ = words3.shape
    shape = (rows, LANES) if reduce else (peers, rows, LANES)
    out = torch.empty(shape, dtype=torch.float32, device=words3.device)
    with torch.cuda.device(words3.device):
        code = fn(_build.ptr(words3), _build.ptr(meta), peers, 2**bits - 1, bits, rows,
                  _build.ptr(out), _build.stream(words3))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return out


def codebook_decode_reduce_3d(words3: torch.Tensor, levels2: torch.Tensor, bits: int):
    """K4: words (peers, rows, 4·bits) int32 CUDA, levels (peers, s+1) fp32
    -> (rows, 128) fp32 peer mean."""
    return _launch(codebook_decode_reduce_3d, "repro_codebook_decode_reduce", words3, levels2,
                   bits, uniform=False, reduce=True)


def uniform_decode_reduce_3d(words3: torch.Tensor, alphas: torch.Tensor, bits: int):
    """K5: words (peers, rows, 4·bits) int32 CUDA, alphas (peers,) fp32
    -> (rows, 128) fp32 peer mean of ``code·2α_p/s − α_p``."""
    return _launch(uniform_decode_reduce_3d, "repro_uniform_decode_reduce", words3, alphas,
                   bits, uniform=True, reduce=True)


def codebook_decode_rows_3d(words3: torch.Tensor, levels2: torch.Tensor, bits: int):
    """K8: words (peers, rows, 4·bits) int32 CUDA, levels (peers, s+1) fp32
    -> (peers, rows, 128) fp32, peer p's decode in band p."""
    return _launch(codebook_decode_rows_3d, "repro_codebook_decode_rows", words3, levels2,
                   bits, uniform=False, reduce=False)


def uniform_decode_rows_3d(words3: torch.Tensor, alphas: torch.Tensor, bits: int):
    """K9: words (peers, rows, 4·bits) int32 CUDA, alphas (peers,) fp32
    -> (peers, rows, 128) fp32, peer p's decode in band p."""
    return _launch(uniform_decode_rows_3d, "repro_uniform_decode_rows", words3, alphas,
                   bits, uniform=True, reduce=False)


for _k in (codebook_decode_reduce_3d, uniform_decode_reduce_3d, codebook_decode_rows_3d,
           uniform_decode_rows_3d):
    _k.launches = 0
del _k
