"""Per-tensor stochastic encode [→ bit-pack] and decode kernels: K12–K17.

The port of ``repro.kernels.quantize``: the uniform (``uniform_*``, α from
a one-element device tensor) and codebook (``codebook_*``, the (s+1,)
levels) flavours of one encode and one decode template
(``csrc/quantize.cu``).  The encodes round a (rows, 128) fp32 tensor
stochastically with an explicit (rows, 128) uniform draw and write int32
codes; the ``*_encode_pack_2d`` flavours (K16, K17) also zero the codes
past the true element count n and pack them into the (rows, 4·bits) wire
words of ``core.quantizers.pack_codes``: they run on the fused encode body
of ``csrc/encode_fused.cu`` (``encode_fused.encode_2d``; on a flat tensor
as it lies, ``encode_fused.encode_flat``).  The decodes map int32 codes
back to ``code·(2α/s) − α`` or ``levels[code]``.  All take CUDA tensors
only; their plain PyTorch versions are in ``kernels.ref`` and the
per-tensor wrappers in ``kernels.ops``.

Every kernel here is bound by its bytes, except where the per-tensor path
gives it a leaf of a few rows: there a launch costs the launch alone.  So
the encode template takes a table of up to ``MAX_SEGMENTS`` tiles, each
with its own levels or α, and :func:`codebook_encode_segments` and
:func:`uniform_encode_segments` encode all of a client's leaves in one
launch of K14 or K12 (counted as that kernel's), each leaf's codes bitwise
those of :func:`codebook_encode_2d` or :func:`uniform_encode_2d` on that
leaf alone.

K16 and K17 share their TPU names with K7 and K6 of ``encode_fused``;
``kernels.launch_counts`` keys every kernel by module and name.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import encode_fused as _e
from .stats import LANES, check_2d

MAX_SEGMENTS = 64        # tiles per launch of the segmented encode (csrc/quantize.cu)


def _meta(name: str, meta: torch.Tensor, like: torch.Tensor, shape: tuple | None = None) -> int:
    """Check an α (``shape`` (1,)) or levels (2 to 256 entries) operand on
    ``like``'s device; returns s."""
    ok = (meta.dtype == torch.float32 and meta.device == like.device and meta.is_contiguous()
          and (meta.shape == shape if shape else meta.dim() == 1 and 2 <= meta.shape[0] <= 256))
    if not ok:
        want = f"a {shape}" if shape else "a (s+1,) with 2 <= s+1 <= 256"
        raise ValueError(f"{name} must be {want} contiguous fp32 tensor on {like.device}, "
                         f"got {tuple(meta.shape)} {meta.dtype} on {meta.device}")
    return meta.shape[0] - 1


def _bits(bits: int) -> int:
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    return 2**bits - 1


def _encode(kernel, fn_name: str, g2: torch.Tensor, rand: torch.Tensor, meta: torch.Tensor,
            s: int):
    check_2d("g", g2)
    check_2d("rand", rand)
    if rand.shape != g2.shape or rand.device != g2.device:
        raise ValueError("rand must match g in shape and device")
    rows = g2.shape[0]
    codes = torch.empty((rows, LANES), dtype=torch.int32, device=g2.device)
    fn = _build.bind("quantize", fn_name, [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(g2.device):
        code = fn(_build.ptr(g2), _build.ptr(rand), _build.ptr(meta), s, rows, _build.ptr(codes),
                  _build.stream(g2))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return codes


def _decode(kernel, fn_name: str, codes2: torch.Tensor, meta: torch.Tensor, s: int):
    check_2d("codes", codes2, dtype=torch.int32)
    fn = _build.bind("quantize", fn_name, [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(codes2.shape, dtype=torch.float32, device=codes2.device)
    with torch.cuda.device(codes2.device):
        code = fn(_build.ptr(codes2), _build.ptr(meta), s, codes2.shape[0], _build.ptr(out),
                  _build.stream(codes2))
    _build.check(code, kernel.__name__)
    kernel.launches += 1
    return out


def uniform_encode_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """K12: g, rand (rows, 128) fp32 CUDA, alpha (1,) fp32 -> (rows, 128)
    int32 codes in [0, 2^bits − 1], the padding included."""
    _meta("alpha", alpha, g2, (1,))
    return _encode(uniform_encode_2d, "repro_uniform_encode", g2, rand, alpha, _bits(bits))


def codebook_encode_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """K14: g, rand (rows, 128) fp32 CUDA, levels (s+1,) fp32 -> (rows, 128)
    int32 codes in [0, s], the padding included."""
    s = _meta("levels", levels, g2)
    return _encode(codebook_encode_2d, "repro_codebook_encode", g2, rand, levels, s)


def _segments(kernel, fn_name: str, g2s: list, rands: list, metas: list, ss) -> torch.Tensor:
    """One launch of the segmented encode ``fn_name`` over tiles (g2s[i],
    rands[i]) with operand metas[i] and s = ss(i, g2s[i], metas[i]), which
    checks that operand; counted in ``kernel.launches``."""
    k = len(g2s)
    if not 1 <= k <= MAX_SEGMENTS or len(rands) != k or len(metas) != k:
        raise ValueError(f"need 1 to {MAX_SEGMENTS} tiles, each with rand and its operand; got "
                         f"{k} g, {len(rands)} rand, {len(metas)} operands")
    for i, (g2, rand) in enumerate(zip(g2s, rands)):
        if rand.shape != g2.shape or g2.device != g2s[0].device or rand.device != g2.device:
            raise ValueError(f"tile {i}: rand must match g in shape, and every tile must lie "
                             f"on {g2s[0].device}")
    desc = []
    for i, (g2, rand, meta) in enumerate(zip(g2s, rands, metas)):
        check_2d(f"g[{i}]", g2)
        check_2d(f"rand[{i}]", rand)
        desc += [g2.data_ptr(), rand.data_ptr(), meta.data_ptr(), ss(i, g2, meta), g2.shape[0]]
    dev = g2s[0].device
    codes = torch.empty((sum(g2.shape[0] for g2 in g2s), LANES), dtype=torch.int32, device=dev)
    fn = _build.bind("quantize", fn_name, [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(dev):
        code = fn((ctypes.c_longlong * len(desc))(*desc), k, _build.ptr(codes),
                  _build.stream(g2s[0]))
    _build.check(code, fn_name)
    kernel.launches += 1
    return codes


def codebook_encode_segments(g2s: list, rands: list, levels: list) -> torch.Tensor:
    """K14 over 1 to ``MAX_SEGMENTS`` tiles in one launch: tile i's g and
    rand (rows_i, 128) fp32 CUDA, its levels (s_i+1,) fp32 -> (Σ rows_i, 128)
    int32 codes, tile i's in rows Σ_{k<i} rows_k onward; each tile's codes
    equal :func:`codebook_encode_2d`'s on it alone.  One launch, counted in
    ``codebook_encode_2d.launches``."""
    return _segments(codebook_encode_2d, "repro_codebook_encode_segments", g2s, rands, levels,
                     lambda i, g2, lv: _meta(f"levels[{i}]", lv, g2))


def uniform_encode_segments(g2s: list, rands: list, alphas: list, bits: list) -> torch.Tensor:
    """K12 over 1 to ``MAX_SEGMENTS`` tiles in one launch: tile i's g and
    rand (rows_i, 128) fp32 CUDA, its α (1,) fp32 on the card and its
    ``bits[i]`` -> (Σ rows_i, 128) int32 codes, stacked as
    :func:`codebook_encode_segments` stacks them; each tile's codes equal
    :func:`uniform_encode_2d`'s on it alone.  One launch, counted in
    ``uniform_encode_2d.launches``."""
    if len(bits) != len(g2s):
        raise ValueError(f"need one bits per tile; got {len(g2s)} tiles and {len(bits)} bits")

    def s_of(i, g2, alpha):
        _meta(f"alpha[{i}]", alpha, g2, (1,))
        return _bits(bits[i])

    return _segments(uniform_encode_2d, "repro_uniform_encode_segments", g2s, rands, alphas, s_of)


def uniform_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor, n: int,
                           bits: int):
    """K16: K12's codes, zeroed past n, and their (rows, 4·bits) int32 wire
    words: ((rows, 128) int32 codes, words); rand 16-byte aligned."""
    return _e.encode_2d(uniform_encode_pack_2d, g2, rand, alpha, n, bits)


def codebook_encode_pack_2d(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor, n: int,
                            bits: int):
    """K17: K14's codes, zeroed past n, and their (rows, 4·bits) int32 wire
    words; levels must have 2^bits entries."""
    return _e.encode_2d(codebook_encode_pack_2d, g2, rand, levels, n, bits)


def uniform_decode_2d(codes2: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """K13: codes (rows, 128) int32 CUDA, alpha (1,) fp32 -> (rows, 128) fp32
    ``code·((2α)/s) − α``."""
    _meta("alpha", alpha, codes2, (1,))
    return _decode(uniform_decode_2d, "repro_uniform_decode", codes2, alpha, _bits(bits))


def codebook_decode_2d(codes2: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """K15: codes (rows, 128) int32 CUDA, levels (s+1,) fp32 -> (rows, 128)
    fp32 ``levels[code]`` (0 for a code outside [0, s])."""
    s = _meta("levels", levels, codes2)
    return _decode(codebook_decode_2d, "repro_codebook_decode", codes2, levels, s)


for _k in (uniform_encode_2d, codebook_encode_2d, uniform_encode_pack_2d, codebook_encode_pack_2d,
           uniform_decode_2d, codebook_decode_2d):
    _k.launches = 0
del _k
# K16 and K17: encode_fused.cu's entry points, and the codes beside the words
uniform_encode_pack_2d.entry = ("repro_uniform_encode_pack_codes", True, _e.CODES)
codebook_encode_pack_2d.entry = ("repro_codebook_encode_pack_codes", False, _e.CODES)
