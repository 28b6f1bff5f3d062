"""Compressor configuration, histogram-driven plans, wire accounting and
the bucket planner — the PyTorch port of ``repro.core.compressors``.

The port has no ``use_pallas`` switch: the device of the tensors decides.
A CUDA tensor goes to the hand-written kernels, a CPU tensor to their plain
PyTorch versions (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import dataclasses

import torch

from . import distributions as dist
from . import optimal
from .quantizers import QuantMeta, num_levels, packed_size, uniform_levels

METHODS = ("dsgd", "qsgd", "nqsgd", "tqsgd", "tnqsgd", "tbqsgd")
#: registered in the JAX package but not ported yet (ROADMAP Queue 1)
_UNPORTED_CODECS = {"fp16": "item 4"}


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    method: str = "tnqsgd"
    bits: int = 3
    gmin_quantile: float = 0.9     # |g| quantile used as g_min for the tail fit
    hist_bins: int = 128           # empirical-density resolution
    alpha_iters: int = 10          # fixed-point iterations for α
    pack: bool = True              # bit-pack codes into uint32 words on the wire
    plan_sample: int = 65536       # max elements used for the statistics pass
    approx_gmin: bool = False      # histogram quantile for g_min (no full sort)
    rank: int = 4                  # factor rank for rank-based codecs (powersgd)

    def __post_init__(self):
        if self.method in _UNPORTED_CODECS:
            raise NotImplementedError(
                f"method {self.method!r} is not ported yet "
                f"(ROADMAP Queue 1 {_UNPORTED_CODECS[self.method]})")
        if self.method not in METHODS:
            # registered codec families beyond the built-in quantizers
            from .codecs import known_methods

            if self.method not in known_methods():
                raise ValueError(
                    f"unknown method {self.method!r}; expected one of {known_methods()}")
        if not (1 <= self.bits <= 8):
            raise ValueError("bits must be in [1, 8]")
        if not (1 <= self.rank <= 64):
            raise ValueError("rank must be in [1, 64]")

    @property
    def s(self) -> int:
        return num_levels(self.bits)


def plan_from_stats(
    cfg: CompressorConfig,
    counts: torch.Tensor,
    log_sums: torch.Tensor,
    g_max: torch.Tensor,
) -> QuantMeta:
    """Quantization plan (codebook + α) from one-pass bucket statistics:
    the 128-bin log2-spaced |g| histogram, its per-bin ln|g| sums and the
    exact max |g| (``kernels.ops.bucket_stats`` / ``ef_correct_stats``)."""
    from repro_torch.kernels.stats import bin_edges

    edges = bin_edges(counts.device)
    tail = dist.tail_from_histogram(counts, log_sums, g_max, edges,
                                    gmin_quantile=cfg.gmin_quantile)
    if cfg.method in ("qsgd", "dsgd"):
        alpha = tail.g_max
        levels = uniform_levels(alpha, cfg.bits)
    elif cfg.method == "tqsgd":
        alpha = optimal.solve_alpha_uniform(tail, cfg.bits, iters=cfg.alpha_iters)
        levels = uniform_levels(alpha, cfg.bits)
    elif cfg.method == "tbqsgd":
        raise NotImplementedError("tbqsgd needs optimal.solve_biscaled (ROADMAP Queue 1 item 1)")
    else:
        dens = dist.density_from_histogram(counts, edges)
        if cfg.method == "nqsgd":
            alpha = tail.g_max
        else:
            alpha = optimal.solve_alpha_nonuniform(tail, dens, cfg.bits, iters=cfg.alpha_iters)
        levels = optimal.nonuniform_codebook(dens, alpha, cfg.bits)
    return QuantMeta(levels=levels.to(torch.float32), alpha=alpha.to(torch.float32))


def _is_plan_entry(entry) -> bool:
    """A per-bucket ``("method", value)`` plan pair (vs a bits list)."""
    return isinstance(entry, list | tuple) and len(entry) == 2 and isinstance(entry[0], str)


def wire_bytes(cfg: CompressorConfig, n_elements, bits=None) -> int:
    """Bytes on the wire for one tensor: the packed payload plus the s+1
    fp32 levels and the fp32 alpha.  ``n_elements`` may be a list of bucket
    sizes, optionally with a matching list of per-bucket ``bits``; a
    per-bucket entry may also be a ``("method", value)`` pair or a full
    config (``core.codecs.bucket_cfg_entry``), and a registered codec
    outside the quantizers (``powersgd``) accounts its own wire."""
    if isinstance(n_elements, list | tuple):
        if isinstance(bits, list | tuple) and not _is_plan_entry(bits):
            if len(bits) != len(n_elements):
                raise ValueError(f"{len(bits)} bit-widths vs {len(n_elements)} buckets")
            return sum(wire_bytes(cfg, n, b) for n, b in zip(n_elements, bits))
        return sum(wire_bytes(cfg, n, bits) for n in n_elements)
    if _is_plan_entry(bits) or isinstance(bits, CompressorConfig):
        from .codecs import bucket_cfg_entry

        return wire_bytes(bucket_cfg_entry(cfg, bits), n_elements)
    if isinstance(bits, list | tuple):
        raise ValueError("per-bucket bits need a matching list of bucket sizes")
    if cfg.method == "dsgd":
        return 4 * n_elements
    if cfg.method not in METHODS:
        from .codecs import get_codec

        return get_codec(cfg.method).wire_bytes(cfg, n_elements)
    b = cfg.bits if bits is None else int(bits)
    if not (1 <= b <= 8):
        raise ValueError("bits must be in [1, 8]")
    payload = 4 * packed_size(n_elements, b) if cfg.pack else n_elements
    return payload + 4 * (num_levels(b) + 2)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static coalescing plan: bucket ``b`` holds the consecutive leaves
    ``ranges[b][0]:ranges[b][1]`` and has ``sizes[b]`` elements."""

    ranges: tuple[tuple[int, int], ...]
    sizes: tuple[int, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.ranges)


def plan_buckets(leaf_sizes: list[int], target_elements: int) -> BucketPlan:
    """Greedy size-targeted coalescing: pack consecutive leaves until the
    next one would push the bucket past ``target_elements``."""
    if not leaf_sizes:
        return BucketPlan((), ())
    target = max(int(target_elements), 1)
    ranges, sizes = [], []
    start, acc = 0, 0
    for i, sz in enumerate(leaf_sizes):
        if acc and acc + sz > target:
            ranges.append((start, i))
            sizes.append(acc)
            start, acc = i, 0
        acc += sz
    ranges.append((start, len(leaf_sizes)))
    sizes.append(acc)
    return BucketPlan(tuple(ranges), tuple(sizes))


def bucket_concat(leaves: list, bp: BucketPlan) -> list:
    """Flatten + concatenate leaves into the plan's fp32 buckets."""
    return [torch.cat([leaves[i].reshape(-1).to(torch.float32) for i in range(a, b)])
            for (a, b) in bp.ranges]


def bucket_split(buckets: list, bp: BucketPlan, shapes: list) -> list:
    """Inverse of :func:`bucket_concat`: slice buckets back into shaped leaves."""
    out = []
    for (a, b), flat in zip(bp.ranges, buckets):
        off = 0
        for i in range(a, b):
            n = 1
            for d in shapes[i]:
                n *= d
            out.append(flat[off:off + n].reshape(shapes[i]))
            off += n
    return out
