"""Codec registry — the quantizer family of ``repro.core.codecs``.

A codec owns the local halves of the bucketed sync: the per-bucket plan,
the fused encode→pack→residual pass and the fused decode→peer-mean pass.
Wire contract: one peer's transmission for an n-element bucket is one 1-D
int32 vector of ``wire_words(cfg, n)`` words holding uint32 bit patterns —
``[packed_size(n, bits) code words][s+1 bitcast float32 levels]``.

Only the codebook quantizers run on the port's kernels so far: the uniform
methods (qsgd, tqsgd, dsgd) wait for their kernels K3/K5 (ROADMAP Queue 2),
and the fp16 tier and powersgd for ROADMAP Queue 1 items 4 and 10.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from repro_torch.adaptive.telemetry import bucket_statistics
from repro_torch.kernels import ops

from .compressors import METHODS, CompressorConfig, plan_from_stats
from .quantizers import QuantMeta, packed_size

# Methods whose codebook is the uniform linspace: the JAX package encodes and
# dequantizes them from α alone, with kernels K3/K5.
_UNIFORM_DECODE = ("qsgd", "tqsgd", "dsgd")


def _codebook_only(cfg: CompressorConfig) -> None:
    if cfg.method in _UNIFORM_DECODE:
        raise NotImplementedError(
            f"{cfg.method!r} encodes through the uniform kernels K3/K5, not ported yet "
            "(ROADMAP Queue 2)")


def _levels_to_wire(levels: torch.Tensor) -> torch.Tensor:
    return levels.to(torch.float32).contiguous().view(torch.int32)


def _levels_from_wire(words: torch.Tensor) -> torch.Tensor:
    return words.contiguous().view(torch.float32)


class QuantizerCodec:
    """The paper's scalar quantizers: one codebook per bucket, shipped in
    the wire after the packed codes."""

    def __init__(self, name: str):
        self.name = name

    def plan(self, cfg: CompressorConfig, flat: torch.Tensor, stat) -> QuantMeta:
        """Histogram-driven plan from precomputed or inline one-pass stats."""
        if stat is None:
            stat = bucket_statistics(flat)
        return plan_from_stats(cfg, stat[0], stat[1], stat[2])

    def wire_words(self, cfg: CompressorConfig, n: int) -> int:
        return packed_size(n, cfg.bits) + cfg.s + 1

    def state_extra(self, cfg: CompressorConfig, n: int) -> int:
        return 0

    def encode_residual(self, cfg: CompressorConfig, flat: torch.Tensor, pln: QuantMeta,
                        key: torch.Tensor):
        """Flat (n,) fp32 -> (wire, EF residual ``flat − own``)."""
        _codebook_only(cfg)
        words, resid = ops.codebook_encode_pack_residual(flat, pln.levels, cfg.bits, key)
        return torch.cat([words, _levels_to_wire(pln.levels)]), resid

    def _split(self, cfg: CompressorConfig, rows: torch.Tensor, n: int):
        w = packed_size(n, cfg.bits)
        return rows[:, :w], _levels_from_wire(rows[:, w:w + cfg.s + 1])

    def decode_reduce(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(peers, wire_words) gathered rows -> (n,) fp32 peer mean."""
        _codebook_only(cfg)
        words, levels = self._split(cfg, rows, n)
        return ops.codebook_decode_reduce(words.contiguous(), levels, n, cfg.bits)


_REGISTRY = {m: QuantizerCodec(m) for m in METHODS}


def get_codec(method: str) -> QuantizerCodec:
    """The registered codec for ``method``."""
    try:
        return _REGISTRY[method]
    except KeyError:
        raise KeyError(f"no codec registered for method {method!r}; known: "
                       f"{tuple(sorted(_REGISTRY))}") from None


def bucket_cfg_entry(cfg: CompressorConfig, entry) -> CompressorConfig:
    """Resolve one per-bucket plan entry — an int bit width, a
    ``("method", bits)`` pair or a full config — to a config."""
    if isinstance(entry, CompressorConfig):
        return entry
    if isinstance(entry, tuple | list):
        if len(entry) != 2 or not isinstance(entry[0], str):
            raise ValueError(f"malformed bits_plan entry {entry!r}: a sequence entry must "
                             "be a ('method', value) pair")
        method, value = entry[0], int(entry[1])
        if method == cfg.method and value == cfg.bits:
            return cfg
        return dataclasses.replace(cfg, method=method, bits=value)
    entry = int(entry)
    return cfg if entry == cfg.bits else dataclasses.replace(cfg, bits=entry)


def bucket_cfgs(cfg: CompressorConfig, n_buckets: int,
                plan: Sequence | None) -> list[CompressorConfig]:
    """Per-bucket compressor configs: ``cfg`` everywhere, or one per entry."""
    if plan is None:
        return [cfg] * n_buckets
    if len(plan) != n_buckets:
        raise ValueError(f"bit plan has {len(plan)} entries for {n_buckets} buckets")
    return [bucket_cfg_entry(cfg, e) for e in plan]


def size_adaptive_plan(cfg: CompressorConfig, plan: Sequence | None, sizes: Sequence[int],
                       threshold: int) -> Sequence | None:
    """The fp16 small-bucket tier: a no-op unless a bucket has at most
    ``threshold`` elements, which needs the fp16 codec (ROADMAP Queue 1
    item 4)."""
    if threshold <= 0 or not any(int(m) <= threshold for m in sizes):
        return plan
    raise NotImplementedError("the fp16 small-bucket tier is not ported yet (ROADMAP Queue 1 item 4)")


def bucket_state_sizes(cfg: CompressorConfig, sizes: Sequence[int],
                       plan: Sequence | None = None) -> list[int]:
    """EF/state row length per bucket: ``m + state_extra`` under the plan."""
    cfgs = bucket_cfgs(cfg, len(sizes), plan)
    return [int(m) + get_codec(c.method).state_extra(c, int(m)) for m, c in zip(sizes, cfgs)]
