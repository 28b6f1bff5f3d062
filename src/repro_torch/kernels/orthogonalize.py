"""Gram–Schmidt orthonormalization kernel (K11) of PowerSGD's P factor.

The port of ``repro.kernels.orthogonalize``: modified Gram–Schmidt with one
reorthogonalization pass per pivot over the ``r`` ≤ 64 columns of a
(rows, r) fp32 factor.  The TPU kernel works on the factor zero-padded to a
(rows_p, 128) tile for its lane registers; this one takes the factor as it
is.  The kernel is ``csrc/orthogonalize.cu``, one thread block per call,
latency-bound on its chain of dependent block-wide reductions.  A factor
of r ≤ ``REG_RANK`` columns and at most ``REG_ROWS`` rows (every factor of
a bucket up to the 4 MB target, so all of the main path's) is held in its
owner threads' registers for the whole loop; a larger one is worked in the
output buffer in global memory.  Both paths reduce in one fixed order and
give the same bits.  Its plain PyTorch version is
``kernels.ref.orthogonalize``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import check_2d

MAX_RANK = 64            # CompressorConfig.rank ≤ 64
EPS = 1e-30              # norm floor: a zero column scales to zero
REG_RANK = 8             # the register path's largest rank
REG_ROWS = 1024          # ... and its largest row count (256 threads × 4 rows)


def on_chip(p: torch.Tensor) -> bool:
    """Whether the (rows, r) factor ``p`` takes the register path."""
    return p.shape[1] <= REG_RANK and p.shape[0] <= REG_ROWS


def orthogonalize_2d(p: torch.Tensor) -> torch.Tensor:
    """K11: (rows, r) fp32 contiguous CUDA factor -> the same shape with its
    columns orthonormalized, in registers where the factor fits
    (:func:`on_chip`), else in global memory."""
    r = p.shape[-1] if p.dim() == 2 else 0
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"p must be (rows, r) with r in [1, {MAX_RANK}], got {tuple(p.shape)}")
    check_2d("p", p, cols=r)
    return _launch(p, on_chip(p))


def _launch(p: torch.Tensor, chip: bool) -> torch.Tensor:
    """One launch of K11 on a checked factor, in registers if ``chip`` (the
    factor must then be :func:`on_chip`), else in global memory; the tests
    hold the two paths to the same bits."""
    fn = _build.bind("orthogonalize", "repro_orthogonalize", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        code = fn(_build.ptr(p), _build.ptr(out), p.shape[0], p.shape[1], int(chip),
                  _build.stream(p))
    _build.check(code, "orthogonalize_2d")
    orthogonalize_2d.launches += 1
    return out


orthogonalize_2d.launches = 0
