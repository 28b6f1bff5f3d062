"""Mesh specs and the card's constants for the roofline — the port of
``repro.launch.mesh``.

:func:`mesh_axes` is the one parser of the launcher's and the dry run's
``--mesh`` specs (``N`` data; ``DxM`` data x model; ``PxDxM`` pod x data x
model), and returns the full axes; :func:`data_parallel_axes` keeps the
data-parallel ones of a spec.  What a model axis above 1 does not cover yet
(MoE, by ROADMAP fact F17; the VLM, audio, SSM and hybrid families; KV
heads that do not divide the axis) stops in
``dist.sharding.check_model_axis`` with :data:`SHARDING_ITEM`'s words.
There are no TPU pods: the JAX package's ``make_production_mesh`` has no
counterpart.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet at dense
rates (no sparsity).  They assume the card's full 700 W power limit; a card
set below it runs slower under load, so a share against them is stated with
the card's limit beside it.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import SHARDING_ITEM, check_model_axis  # noqa: F401

#: tensor-core peaks, FLOP/s
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_TF32 = 495e12
#: float32 outside the tensor cores (and a float32 matmul with TF32 off)
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12               # B/s
HBM_PER_CHIP = 80e9            # bytes (80 GB)
NVLINK_BW = 450e9              # B/s each way, to the other cards of the host


def matmul_peak(dtype: torch.dtype, tf32: bool) -> float:
    """FLOP/s of a matrix product whose inputs are ``dtype``: the tensor
    cores' rate for bf16 and fp16, TF32's for float32 when it is allowed,
    else float32's outside the tensor cores (which float64 does not beat)."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS_BF16
    if dtype == torch.float32 and tf32:
        return PEAK_FLOPS_TF32
    return PEAK_FLOPS_FP32


def mesh_axes(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``--mesh`` as the JAX launcher reads it: '4' -> ('data',), '4x2' ->
    ('data', 'model'), '2x4x2' -> ('pod', 'data', 'model')."""
    try:
        dims = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}") from None
    names = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if names is None or min(dims) < 1:
        raise ValueError(f"bad mesh spec {spec!r}")
    return names, dims


def data_parallel_axes(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """The data-parallel axes of ``spec`` (its model axis dropped) and their
    sizes."""
    names, dims = mesh_axes(spec)
    keep = [i for i, n in enumerate(names) if n != "model"]
    return tuple(names[i] for i in keep), tuple(dims[i] for i in keep)
