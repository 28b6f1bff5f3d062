"""Mesh specs and the card's constants for the roofline — the port of
``repro.launch.mesh``.

:func:`mesh_axes` is the one parser of the launcher's and the dry run's
``--mesh`` specs (``N`` data; ``DxM`` data x model; ``PxDxM`` pod x data x
model).  :func:`data_parallel_axes` keeps the data-parallel axes of a spec:
the port's mesh has no model axis until its sharding rules land, so a model
axis above 1 raises with :data:`SHARDING_ITEM`'s words.  There are no TPU
pods: the JAX package's ``make_production_mesh`` has no counterpart.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet at dense
rates (no sparsity).  They assume the card's full 700 W power limit; a card
set below it runs slower under load, so a share against them is stated with
the card's limit beside it.
"""
from __future__ import annotations

import torch

SHARDING_ITEM = "ROADMAP Queue 1, item 4.2 (dist/sharding.py: tensor and expert parallelism)"

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
    """The data-parallel axes of ``spec`` (its model axis of 1 dropped) and
    their sizes; a model axis above 1 raises."""
    names, dims = mesh_axes(spec)
    if "model" in names and dims[-1] != 1:
        raise ValueError(f"--mesh {spec}: a model axis of {dims[-1]} waits for {SHARDING_ITEM}")
    keep = [i for i, n in enumerate(names) if n != "model"]
    return tuple(names[i] for i in keep), tuple(dims[i] for i in keep)
