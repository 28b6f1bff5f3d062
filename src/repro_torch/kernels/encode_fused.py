"""Fused encode-side kernels: EF-correct→stats (K1) and quantize→pack
[→residual] (K2, K3, K6, K7).

The port of ``repro.kernels.encode_fused``.  ``ef_correct_stats_2d`` reads a
gradient bucket and its EF residual once, writes ``c = g + e`` and the
statistics tile of c (``csrc/stats.cu`` with the EF add compiled in);
``ef_correct_stats_flat`` launches it on the buffers as they lie.  The
four encode kernels round c stochastically onto the bucket's codebook
(``codebook_*``) or onto the uniform grid over [−α, α] (``uniform_*``),
pack the codes into the wire words and, in the ``*_resid_2d`` flavours,
write the next EF residual ``c − dequant(code)`` in the same pass
(``csrc/encode_fused.cu``).  All take CUDA tensors only; their plain
PyTorch versions are in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import LANES, check_2d, check_flat, tile_and_scratch


def ef_correct_stats_2d(g2: torch.Tensor, e2: torch.Tensor, n: int):
    """K1: g, e (rows, 128) fp32 CUDA, n true elements ->
    ((rows, 128) corrected c, (STATS_ROWS, NUM_BINS) stats tile of c)."""
    check_2d("g", g2)
    check_2d("e", e2)
    if e2.shape != g2.shape:
        raise ValueError(f"e {tuple(e2.shape)} must match g {tuple(g2.shape)}")
    c, out = ef_correct_stats_flat(g2, e2, n)
    return c.reshape(g2.shape), out


def ef_correct_stats_flat(g: torch.Tensor, e: torch.Tensor, n: int):
    """K1 on contiguous fp32 CUDA buffers of one length, as they lie (no
    padding, any alignment) -> (flat ``c = g + e`` over the whole length,
    stats tile of c's first n elements).  A launch of K1, counted in
    ``ef_correct_stats_2d.launches``."""
    check_flat("g", g)
    check_flat("e", e, g.numel())
    if e.device != g.device:
        raise ValueError(f"e on {e.device} must lie on g's device {g.device}")
    total = g.numel()
    if not 1 <= n <= total:
        raise ValueError(f"n={n} outside [1, {total}]")
    fn = _build.bind("stats", "repro_ef_correct_stats", [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    c = torch.empty(total, dtype=torch.float32, device=g.device)
    out, work = tile_and_scratch(total, g.device)
    with torch.cuda.device(g.device):
        code = fn(_build.ptr(g), _build.ptr(e), _build.ptr(c), _build.ptr(work), _build.ptr(out),
                  n, total, _build.stream(g))
    _build.check(code, "ef_correct_stats_2d")
    ef_correct_stats_2d.launches += 1
    return c, out


ef_correct_stats_2d.launches = 0


def _check_encode(g2: torch.Tensor, rand: torch.Tensor, meta: torch.Tensor, n: int,
                  bits: int, uniform: bool) -> None:
    check_2d("g", g2)
    check_2d("rand", rand)
    if rand.shape != g2.shape or rand.device != g2.device:
        raise ValueError("rand must match g in shape and device")
    shape = (1,) if uniform else (2**bits,)
    what = "alpha" if uniform else "levels"
    if (meta.shape != shape or meta.device != g2.device or meta.dtype != torch.float32
            or not meta.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {shape} fp32 tensor on "
                         f"{g2.device} for bits={bits}, got {tuple(meta.shape)} "
                         f"{meta.dtype} on {meta.device}")
    if not 1 <= n <= g2.numel():
        raise ValueError(f"n={n} outside [1, {g2.numel()}]")


def _launch(kernel, fn_name: str, g2: torch.Tensor, rand: torch.Tensor, meta: torch.Tensor,
            n: int, bits: int, uniform: bool, resid: bool):
    _check_encode(g2, rand, meta, n, bits, uniform)
    fn = _build.bind("encode_fused", fn_name, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_void_p] * (3 if resid else 2))
    rows = g2.shape[0]
    words = torch.empty((rows, (LANES // 32) * bits), dtype=torch.int32, device=g2.device)
    out = [_build.ptr(words)]
    if resid:
        r = torch.empty_like(g2)
        out.append(_build.ptr(r))
    with torch.cuda.device(g2.device):
        code = fn(_build.ptr(g2), _build.ptr(rand), _build.ptr(meta), 2**bits - 1, bits, n, rows,
                  *out, _build.stream(g2))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return (words, r) if resid else words


def codebook_encode_pack_resid_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                                  n: int, bits: int):
    """K2: g, rand (rows, 128) fp32 CUDA, levels (s+1,) fp32 ->
    ((rows, 4·bits) int32 wire words, (rows, 128) fp32 residual)."""
    return _launch(codebook_encode_pack_resid_2d, "repro_codebook_encode_pack_resid", g2, rand,
                   levels, n, bits, uniform=False, resid=True)


def uniform_encode_pack_resid_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                                 n: int, bits: int):
    """K3: g, rand (rows, 128) fp32 CUDA, alpha (1,) fp32 ->
    ((rows, 4·bits) int32 wire words, (rows, 128) fp32 residual)."""
    return _launch(uniform_encode_pack_resid_2d, "repro_uniform_encode_pack_resid", g2, rand,
                   alpha, n, bits, uniform=True, resid=True)


def codebook_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                            n: int, bits: int):
    """K6: K2's wire words alone."""
    return _launch(codebook_encode_pack_2d, "repro_codebook_encode_pack", g2, rand, levels, n,
                   bits, uniform=False, resid=False)


def uniform_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                           n: int, bits: int):
    """K7: K3's wire words alone."""
    return _launch(uniform_encode_pack_2d, "repro_uniform_encode_pack", g2, rand, alpha, n,
                   bits, uniform=True, resid=False)


for _k in (codebook_encode_pack_resid_2d, uniform_encode_pack_resid_2d, codebook_encode_pack_2d,
           uniform_encode_pack_2d):
    _k.launches = 0
del _k
