"""Gram–Schmidt orthonormalization kernel (K11) of PowerSGD's P factor.

The port of ``repro.kernels.orthogonalize``: modified Gram–Schmidt with one
reorthogonalization pass per pivot over the ``r`` ≤ 64 columns of a
(rows, r) fp32 factor.  The TPU kernel works on the factor zero-padded to a
(rows_p, 128) tile for its lane registers; this one takes the factor as it
is.  The kernel is ``csrc/orthogonalize.cu``, one thread block per call;
its plain PyTorch version is ``kernels.ref.orthogonalize``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .stats import check_2d

MAX_RANK = 64            # CompressorConfig.rank ≤ 64
EPS = 1e-30              # norm floor: a zero column scales to zero


def orthogonalize_2d(p: torch.Tensor) -> torch.Tensor:
    """K11: (rows, r) fp32 contiguous CUDA factor -> the same shape with its
    columns orthonormalized."""
    r = p.shape[-1] if p.dim() == 2 else 0
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"p must be (rows, r) with r in [1, {MAX_RANK}], got {tuple(p.shape)}")
    check_2d("p", p, cols=r)
    fn = _build.bind("orthogonalize", "repro_orthogonalize", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        code = fn(_build.ptr(p), _build.ptr(out), p.shape[0], r, _build.stream(p))
    _build.check(code, "orthogonalize_2d")
    orthogonalize_2d.launches += 1
    return out


orthogonalize_2d.launches = 0
