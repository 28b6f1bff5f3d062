"""Roofline terms of a dry run on the H100 — the port of
``repro.launch.roofline``.

Three terms per (arch × shape × mesh), in seconds, per device and step:

    compute    = Σ_dtype matmul FLOPs / that dtype's peak
                 + elementwise FLOPs / the float32 peak
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / NVLINK_BW

The counts come from ``launch.op_cost`` (an eager run over meta tensors)
and, for the gradient sync, from ``dist.collectives``' accounting.  A
float32 matmul runs at TF32's peak only when TF32 is allowed: the LM step
turns it off (``train._float32_and_deterministic``), so its float32
attention tiles count at 67 TFLOP/s.  Elementwise FLOPs run outside the
tensor cores and count at the float32 peak whatever their dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, matmul_peak


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float
    collectives: CollectiveStats
    matmul_flops: dict = dataclasses.field(default_factory=dict)   # dtype name -> FLOPs
    elementwise_flops: float = 0.0
    tf32: bool = False
    raw_flops: float = 0.0   # XLA's cost_analysis in the JAX package; no counterpart here
    raw_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        mm = sum(v / matmul_peak(getattr(torch, k), self.tf32)
                 for k, v in self.matmul_flops.items())
        return mm + self.elementwise_flops / PEAK_FLOPS_FP32

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        """The JAX package's record keys, then the port's own."""
        return {
            "flops": self.flops,
            "raw_flops": self.raw_flops,
            "raw_bytes": self.raw_bytes,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_bytes_by_kind": self.collectives.bytes_by_kind,
            "collective_count_by_kind": self.collectives.count_by_kind,
            "matmul_flops_by_dtype": self.matmul_flops,
            "elementwise_flops": self.elementwise_flops,
            "tf32": self.tf32,
        }


def build_roofline(cost, model_flops: float, tf32: bool = False) -> Roofline:
    """Roofline terms from an ``op_cost.Cost``."""
    stats = CollectiveStats(bytes_by_kind=dict(cost.coll), count_by_kind=dict(cost.coll_count))
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes,
                    collective_bytes=stats.total_bytes, model_flops=model_flops,
                    collectives=stats, matmul_flops=dict(cost.matmul_flops),
                    elementwise_flops=cost.elementwise_flops, tf32=tf32)


def model_flops_for(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS convention: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (decode, one token).  Per device: divided by
    chip count at the call site (we report per-device terms)."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def mfu(model_flops: float, step_s: float) -> float:
    """Model FLOPs utilization: ``model_flops`` over what the card's bf16
    peak does in ``step_s`` seconds."""
    return model_flops / (step_s * PEAK_FLOPS_BF16)
