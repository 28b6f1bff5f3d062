"""Fused unpack → dequant → peer-mean (or per-peer) kernels: K4, K5, K8, K9.

The port of ``repro.kernels.decode``: every peer's packed wire rows plus
that peer's codebook (or its α, for the uniform methods) in, and either the
(rows, 128) fp32 peer mean (``*_reduce_3d``) or one (rows, 128) band per
peer (``*_rows_3d``, the all-gather phase-2 sites) out, without
materializing the (peers, n) code tensor (``csrc/decode.cu``).  The peers
are summed in order and divided once by their count, which makes the
reductions bit-exact against their plain versions in ``kernels.ref``.

The ``*_3d`` entry points take the JAX package's zero-padded (peers, rows,
4·bits) layout; :func:`from_wire` launches the same kernel on the stacked
(peers, packed_size(n, bits)) wire as the codec leaves it (its rows may be
strided), reading the words past the wire as zero, so the card path needs
no padded copy.  :func:`serial_3d` launches the one-thread-per-element body
the kernel replaced, uncounted, for the card checks and timings alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantizers import packed_size

from . import _build
from .stats import LANES


def words_per_row(bits: int) -> int:
    """uint32 wire words per (128,) element row: 4 groups of 32 × bit-planes."""
    return (LANES // 32) * bits


def _check_meta(meta: torch.Tensor, peers: int, bits: int, uniform: bool, device) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    shape = (peers,) if uniform else (peers, 2**bits)
    what = "alphas" if uniform else "levels"
    if (meta.shape != shape or meta.dtype != torch.float32
            or meta.device != device or not meta.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {shape} fp32 tensor "
                         f"on {device}, got {tuple(meta.shape)} {meta.dtype}")


def _check(words3: torch.Tensor, meta: torch.Tensor, bits: int, uniform: bool) -> None:
    if words3.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got one on {words3.device}")
    if (words3.dtype != torch.int32 or words3.dim() != 3 or words3.shape[1] < 1
            or words3.shape[2] != words_per_row(bits) or not words3.is_contiguous()):
        raise ValueError(f"words must be a contiguous (peers, rows, {words_per_row(bits)}) "
                         f"int32 tensor, got {tuple(words3.shape)} {words3.dtype}")
    _check_meta(meta, words3.shape[0], bits, uniform, words3.device)


def _launch(kernel, words: torch.Tensor, stride: int, valid: int, meta: torch.Tensor, bits: int,
            rows: int) -> torch.Tensor:
    fn_name, uniform, reduce = _ENTRY[kernel.__name__]
    fn = _build.bind("decode", fn_name, [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                                         ctypes.c_void_p])
    peers = words.shape[0]
    shape = (rows, LANES) if reduce else (peers, rows, LANES)
    out = torch.empty(shape, dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        code = fn(_build.ptr(words), stride, valid, _build.ptr(meta), peers, 2**bits - 1, bits,
                  rows, _build.ptr(out), _build.stream(words))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return out


def _launch_3d(kernel, words3: torch.Tensor, meta: torch.Tensor, bits: int) -> torch.Tensor:
    _check(words3, meta, bits, _ENTRY[kernel.__name__][1])
    rows = words3.shape[1]
    per_peer = rows * words_per_row(bits)
    return _launch(kernel, words3, per_peer, per_peer, meta, bits, rows)


def codebook_decode_reduce_3d(words3: torch.Tensor, levels2: torch.Tensor, bits: int):
    """K4: words (peers, rows, 4·bits) int32 CUDA, levels (peers, s+1) fp32
    -> (rows, 128) fp32 peer mean."""
    return _launch_3d(codebook_decode_reduce_3d, words3, levels2, bits)


def uniform_decode_reduce_3d(words3: torch.Tensor, alphas: torch.Tensor, bits: int):
    """K5: words (peers, rows, 4·bits) int32 CUDA, alphas (peers,) fp32
    -> (rows, 128) fp32 peer mean of ``code·2α_p/s − α_p``."""
    return _launch_3d(uniform_decode_reduce_3d, words3, alphas, bits)


def codebook_decode_rows_3d(words3: torch.Tensor, levels2: torch.Tensor, bits: int):
    """K8: words (peers, rows, 4·bits) int32 CUDA, levels (peers, s+1) fp32
    -> (peers, rows, 128) fp32, peer p's decode in band p."""
    return _launch_3d(codebook_decode_rows_3d, words3, levels2, bits)


def uniform_decode_rows_3d(words3: torch.Tensor, alphas: torch.Tensor, bits: int):
    """K9: words (peers, rows, 4·bits) int32 CUDA, alphas (peers,) fp32
    -> (peers, rows, 128) fp32, peer p's decode in band p."""
    return _launch_3d(uniform_decode_rows_3d, words3, alphas, bits)


def from_wire(kernel, words: torch.Tensor, meta: torch.Tensor, n: int, bits: int):
    """``kernel`` (one of the four ``*_3d`` wrappers, whose launch it counts)
    on the stacked wire: words (peers, packed_size(n, bits)) int32 CUDA, each
    row contiguous, the rows at any stride.  Returns what ``kernel`` returns
    on the wire zero-padded to (peers, ceil(n/128), 4·bits), bit for bit."""
    if words.device.type != "cuda":
        raise ValueError(f"words must be a CUDA tensor, got one on {words.device}")
    w = packed_size(n, bits) if n >= 1 else 0
    if (words.dtype != torch.int32 or words.dim() != 2 or words.shape[0] < 1 or w < 1
            or words.shape[1] != w or words.stride(1) != 1 or words.stride(0) < w):
        raise ValueError(f"wire must be (peers, {w}) int32 for {n} elements at {bits} bits, "
                         f"each row contiguous; got {tuple(words.shape)} {words.dtype} "
                         f"strides {words.stride()}")
    _check_meta(meta, words.shape[0], bits, _ENTRY[kernel.__name__][1], words.device)
    return _launch(kernel, words, words.stride(0), w, meta, bits, -(-n // LANES))


def serial_3d(uniform: bool, reduce: bool, words3: torch.Tensor, meta: torch.Tensor,
              bits: int) -> torch.Tensor:
    """The replaced one-thread-per-element body on the ``*_3d`` operands:
    bitwise the kernel it stands beside; launched only to check and time
    that kernel, so it counts no launch."""
    _check(words3, meta, bits, uniform)
    fn = _build.bind("decode", "repro_decode_serial", [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p])
    peers, rows, _ = words3.shape
    out = torch.empty((rows, LANES) if reduce else (peers, rows, LANES), dtype=torch.float32,
                      device=words3.device)
    with torch.cuda.device(words3.device):
        code = fn(int(uniform), int(reduce), _build.ptr(words3), _build.ptr(meta), peers,
                  2**bits - 1, bits, rows, _build.ptr(out), _build.stream(words3))
    _build.check(code, "decode serial body")
    return out


# wrapper name -> (C entry point, uniform, reduce)
_ENTRY = {
    "codebook_decode_reduce_3d": ("repro_codebook_decode_reduce", False, True),
    "uniform_decode_reduce_3d": ("repro_uniform_decode_reduce", True, True),
    "codebook_decode_rows_3d": ("repro_codebook_decode_rows", False, False),
    "uniform_decode_rows_3d": ("repro_uniform_decode_rows", True, False),
}
for _k in (codebook_decode_reduce_3d, uniform_decode_reduce_3d, codebook_decode_rows_3d,
           uniform_decode_rows_3d):
    _k.launches = 0
del _k
