"""Fused encode-side kernels: EF-correct→stats (K1) and quantize→pack
[→residual] (K2, K3, K6, K7), and the body K16 and K17 run on.

The port of ``repro.kernels.encode_fused``.  ``ef_correct_stats_2d`` reads a
gradient bucket and its EF residual once, writes ``c = g + e`` and the
statistics tile of c (``csrc/stats.cu`` with the EF add compiled in);
``ef_correct_stats_flat`` launches it on the buffers as they lie.  The
four encode kernels round c stochastically onto the bucket's codebook
(``codebook_*``) or onto the uniform grid over [−α, α] (``uniform_*``),
pack the codes into the wire words and, in the ``*_resid_2d`` flavours,
write the next EF residual ``c − dequant(code)`` in the same pass
(``csrc/encode_fused.cu``).  The same body, writing the codes beside the
words, is ``kernels.quantize``'s ``uniform_encode_pack_2d`` (K16) and
``codebook_encode_pack_2d`` (K17).  :func:`encode_2d` launches any of the
six on the JAX package's zero-padded (rows, 128) tile; :func:`encode_flat`
launches it on the bucket as it lies (any alignment, shorter than the code
length), reading the elements past it as zero, so the card path needs no
padded copy.  :func:`serial_2d` launches the one-thread-per-element body
K2, K3, K6 and K7 replaced, uncounted, for the card checks and timings
alone.  All take CUDA tensors only; their plain PyTorch versions are in
``kernels.ref``.
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


def _check_meta(meta: torch.Tensor, bits: int, uniform: bool, device) -> None:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    shape = (1,) if uniform else (2**bits,)
    what = "alpha" if uniform else "levels"
    if (meta.shape != shape or meta.device != device or meta.dtype != torch.float32
            or not meta.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {shape} fp32 tensor on "
                         f"{device} for bits={bits}, got {tuple(meta.shape)} "
                         f"{meta.dtype} on {meta.device}")


def _check_rand(rand: torch.Tensor, rows: int, device) -> None:
    check_2d("rand", rand)
    if rand.shape != (rows, LANES) or rand.device != device or rand.data_ptr() % 16:
        raise ValueError(f"rand must be a 16-byte aligned ({rows}, {LANES}) tile on {device}, "
                         f"got {tuple(rand.shape)} on {rand.device} at byte offset "
                         f"{rand.data_ptr() % 16}")


def _check_2d(g2: torch.Tensor, rand: torch.Tensor, meta: torch.Tensor, n: int, bits: int,
              uniform: bool) -> None:
    check_2d("g", g2)
    _check_rand(rand, g2.shape[0], g2.device)
    _check_meta(meta, bits, uniform, g2.device)
    if not 1 <= n <= g2.numel():
        raise ValueError(f"n={n} outside [1, {g2.numel()}]")


# what an encode writes beside the words (``kernel.entry[2]``)
WORDS, RESID, CODES = "words", "residual", "codes"


def _launch(kernel, c: torch.Tensor, n: int, rows: int, rand: torch.Tensor, meta: torch.Tensor,
            bits: int):
    """One launch of ``kernel``'s body on checked operands: the first
    ``c.numel()`` elements of the (rows, 128) tile read from c, the rest as
    zero.  Returns the (rows, 4·bits) words, with the residual of c's
    elements after them for the residual flavours, or the (rows, 128) codes
    before them for the codes flavours."""
    fn_name, _, out = kernel.entry
    words = torch.empty((rows, (LANES // 32) * bits), dtype=torch.int32, device=c.device)
    if out == RESID:
        result = (words, torch.empty(c.numel(), dtype=torch.float32, device=c.device))
    elif out == CODES:
        result = (torch.empty((rows, LANES), dtype=torch.int32, device=c.device), words)
    else:
        result = (words,)
    fn = _build.bind("encode_fused", fn_name, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * (len(result) + 1))
    with torch.cuda.device(c.device):
        code = fn(_build.ptr(c), c.numel(), _build.ptr(rand), _build.ptr(meta), bits, n, rows,
                  *[_build.ptr(t) for t in result], _build.stream(c))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return words if out == WORDS else result


def encode_2d(kernel, g2: torch.Tensor, rand: torch.Tensor, meta: torch.Tensor, n: int,
              bits: int):
    """``kernel`` (K2, K3, K6, K7 here, K16, K17 in ``kernels.quantize``,
    whose launch it counts) on the (rows, 128) tile g2 with code length n;
    the residual, where the kernel writes one, comes back as a (rows, 128)
    tile."""
    _check_2d(g2, rand, meta, n, bits, kernel.entry[1])
    out = _launch(kernel, g2, n, g2.shape[0], rand, meta, bits)
    return (out[0], out[1].reshape(g2.shape)) if kernel.entry[2] == RESID else out


def codebook_encode_pack_resid_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                                  n: int, bits: int):
    """K2: g, rand (rows, 128) fp32 CUDA, levels (s+1,) fp32 ->
    ((rows, 4·bits) int32 wire words, (rows, 128) fp32 residual)."""
    return encode_2d(codebook_encode_pack_resid_2d, g2, rand, levels, n, bits)


def uniform_encode_pack_resid_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                                 n: int, bits: int):
    """K3: g, rand (rows, 128) fp32 CUDA, alpha (1,) fp32 ->
    ((rows, 4·bits) int32 wire words, (rows, 128) fp32 residual)."""
    return encode_2d(uniform_encode_pack_resid_2d, g2, rand, alpha, n, bits)


def codebook_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                            n: int, bits: int):
    """K6: K2's wire words alone."""
    return encode_2d(codebook_encode_pack_2d, g2, rand, levels, n, bits)


def uniform_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                           n: int, bits: int):
    """K7: K3's wire words alone."""
    return encode_2d(uniform_encode_pack_2d, g2, rand, alpha, n, bits)


def encode_flat(kernel, c: torch.Tensor, n: int, rand: torch.Tensor, meta: torch.Tensor,
                bits: int):
    """``kernel`` (one of the six encode wrappers :func:`encode_2d` takes,
    whose launch it counts) on the bucket as it lies: c contiguous fp32
    CUDA, m = c.numel() elements at any 4-byte alignment, code length n >= m
    (elements m .. n-1 read as zero, as the zero-padded tile has them), rand
    the 16-byte aligned (ceil(n/128), 128) tile ``prng.uniform`` draws.
    Returns what ``kernel`` returns on c zero-padded to that tile, bit for
    bit, except that a residual is c's own (m,) residual."""
    check_flat("c", c)
    m = c.numel()
    if n < m:
        raise ValueError(f"code length n={n} below the bucket's {m} elements")
    rows = -(-n // LANES)
    _check_rand(rand, rows, c.device)
    _check_meta(meta, bits, kernel.entry[1], c.device)
    return _launch(kernel, c, n, rows, rand, meta, bits)


def serial_2d(uniform: bool, resid: bool, g2: torch.Tensor, rand: torch.Tensor,
              meta: torch.Tensor, n: int, bits: int):
    """The replaced one-thread-per-element body on the ``*_2d`` operands:
    bitwise the kernel it stands beside; launched only to check and time
    that kernel, so it counts no launch."""
    _check_2d(g2, rand, meta, n, bits, uniform)
    fn = _build.bind("encode_fused", "repro_encode_serial", [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    rows = g2.shape[0]
    words = torch.empty((rows, (LANES // 32) * bits), dtype=torch.int32, device=g2.device)
    r = torch.empty_like(g2) if resid else None
    with torch.cuda.device(g2.device):
        code = fn(int(uniform), int(resid), _build.ptr(g2), _build.ptr(rand), _build.ptr(meta),
                  bits, n, rows, _build.ptr(words), _build.ptr(r) if resid else None,
                  _build.stream(g2))
    _build.check(code, "encode serial body")
    return (words, r) if resid else words


# each wrapper's C entry point, whether it is uniform, and what it writes
# beside the words
for _k, _entry in ((codebook_encode_pack_resid_2d, ("repro_codebook_encode_pack_resid", False,
                                                    RESID)),
                   (uniform_encode_pack_resid_2d, ("repro_uniform_encode_pack_resid", True, RESID)),
                   (codebook_encode_pack_2d, ("repro_codebook_encode_pack", False, WORDS)),
                   (uniform_encode_pack_2d, ("repro_uniform_encode_pack", True, WORDS))):
    _k.launches = 0
    _k.entry = _entry
del _k, _entry
