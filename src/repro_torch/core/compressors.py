"""Compressor configuration, plans, the per-tensor wire ops, wire
accounting and the bucket planner — the PyTorch port of
``repro.core.compressors``.

``plan`` fits the per-tensor codebook and α with the sort-based
statistics pass, ``plan_from_stats`` from the bucketed codec's one-pass
statistics.  ``encode``/``decode`` are the per-tensor wire ops, and there
``CompressorConfig.use_pallas`` keeps its JAX meaning: ``True`` draws the
rounding uniforms on the padded (rows, 128) tile and encodes through
``kernels.ops.uniform_encode``/``codebook_encode`` (kernels K12/K14 on a
CUDA tensor, their plain versions on a CPU tensor); ``False`` runs
``quantizers.stochastic_encode`` in torch ops, drawing one uniform per
element.  The two streams differ unless n is a multiple of 128.
``compress_decompress_leaves`` compresses a list of leaves, each as
``compress_decompress`` does, with one K14 launch for all the codebook
leaves.  The bucketed codec (``core.codecs``) ignores the flag: there the
JAX package's two branches are bit-identical, and the device of the
tensors decides.
"""
from __future__ import annotations

import dataclasses

import torch

from . import distributions as dist
from . import optimal, prng
from .quantizers import (QuantMeta, decode as _decode, num_levels, pack_codes, packed_size,
                         stochastic_encode, uniform_levels, unpack_codes)

METHODS = ("dsgd", "qsgd", "nqsgd", "tqsgd", "tnqsgd", "tbqsgd")
#: methods whose codebook is the uniform grid over [−α, α]
_UNIFORM = ("qsgd", "tqsgd", "dsgd")


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    method: str = "tnqsgd"
    bits: int = 3
    gmin_quantile: float = 0.9     # |g| quantile used as g_min for the tail fit
    hist_bins: int = 128           # empirical-density resolution
    alpha_iters: int = 10          # fixed-point iterations for α
    use_pallas: bool = False       # per-tensor encode through the K12/K14 kernels
    pack: bool = True              # bit-pack codes into uint32 words on the wire
    plan_sample: int = 65536       # max elements used for the statistics pass
    approx_gmin: bool = False      # histogram quantile for g_min (no full sort)
    rank: int = 4                  # factor rank for rank-based codecs (powersgd)

    def __post_init__(self):
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


def _plan_from(cfg: CompressorConfig, tail: dist.PowerLawTail, density) -> QuantMeta:
    """The method's α and codebook from a fitted tail; ``density()`` gives
    the empirical density and is called only by the non-uniform methods."""
    if cfg.method == "tqsgd":
        alpha = optimal.solve_alpha_uniform(tail, cfg.bits, iters=cfg.alpha_iters)
        levels = uniform_levels(alpha, cfg.bits)
    elif cfg.method in ("nqsgd", "tnqsgd", "tbqsgd"):
        dens = density()
        if cfg.method == "nqsgd":
            alpha = tail.g_max
            levels = optimal.nonuniform_codebook(dens, alpha, cfg.bits)
        elif cfg.method == "tnqsgd":
            alpha = optimal.solve_alpha_nonuniform(tail, dens, cfg.bits, iters=cfg.alpha_iters)
            levels = optimal.nonuniform_codebook(dens, alpha, cfg.bits)
        else:
            alpha, k = optimal.solve_biscaled(tail, dens, cfg.bits, iters=cfg.alpha_iters)
            levels = optimal.biscaled_codebook(dens, alpha, k, cfg.bits)
    else:  # qsgd, dsgd
        alpha = tail.g_max
        levels = uniform_levels(alpha, cfg.bits)
    return QuantMeta(levels=levels.to(torch.float32), alpha=alpha.to(torch.float32))


_PLAN_SAMPLE_CHUNKS = 64


def _plan_sample(g32: torch.Tensor, sample: int) -> torch.Tensor:
    """Statistics subsample of a flat fp32 tensor: ``_PLAN_SAMPLE_CHUNKS``
    contiguous runs at evenly spaced offsets (never more runs than sampled
    elements), so the sample spreads over the whole tensor."""
    n = g32.numel()
    if not sample or n <= sample:
        return g32
    chunks = max(min(_PLAN_SAMPLE_CHUNKS, sample), 1)
    span = n // chunks
    run = max(min(sample // chunks, span), 1)
    return g32[: chunks * span].reshape(chunks, span)[:, :run].reshape(-1)


def plan(cfg: CompressorConfig, g: torch.Tensor) -> QuantMeta:
    """The per-tensor plan (codebook + α) for ``g`` from the sort-based
    statistics pass (Alg. 1 line 6): the power-law tail fit and, for the
    non-uniform methods, the empirical density, over at most
    ``plan_sample`` elements (contiguous runs, ``_plan_sample``)."""
    g32 = _plan_sample(g.reshape(-1).to(torch.float32), cfg.plan_sample)
    tail = dist.fit_power_law_tail(g32, gmin_quantile=cfg.gmin_quantile,
                                   approx_quantile=cfg.approx_gmin)
    return _plan_from(cfg, tail, lambda: dist.fit_empirical_density(g32, num_bins=cfg.hist_bins))


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
    return _plan_from(cfg, tail, lambda: dist.density_from_histogram(counts, edges))


def encode(cfg: CompressorConfig, g: torch.Tensor, meta: QuantMeta,
           key: torch.Tensor) -> torch.Tensor:
    """Encode ``g`` to the wire: int32 words with the bits of ``pack_codes``
    (or uint8 codes with ``pack=False``).  ``use_pallas`` picks the encode
    as in the JAX package (module docstring)."""
    flat = g.reshape(-1).to(torch.float32)
    if cfg.use_pallas:
        from repro_torch.kernels import ops

        if cfg.method in _UNIFORM:
            codes = ops.uniform_encode(flat, meta.alpha, cfg.bits, key)
        else:
            codes = ops.codebook_encode(flat, meta.levels, key)
    else:
        codes = stochastic_encode(flat, meta, key)
    return _wire(cfg, codes)


def _wire(cfg: CompressorConfig, codes: torch.Tensor) -> torch.Tensor:
    return pack_codes(codes, cfg.bits) if cfg.pack else codes


def decode(cfg: CompressorConfig, wire: torch.Tensor, meta: QuantMeta,
           shape: tuple[int, ...]) -> torch.Tensor:
    """Wire -> ``levels[code]`` in ``shape``; raises on a wire whose length
    disagrees with the shape and bits."""
    n = 1
    for d in shape:
        n *= d
    if cfg.pack:
        expected = packed_size(n, cfg.bits)
        if tuple(wire.shape) != (expected,):
            raise ValueError(
                f"wire has shape {tuple(wire.shape)}; {n} elements at "
                f"{cfg.bits} bits need ({expected},) packed uint32 words")
        codes = unpack_codes(wire, n, cfg.bits)
    else:
        if tuple(wire.shape) != (n,):
            raise ValueError(
                f"unpacked wire has shape {tuple(wire.shape)}; expected ({n},) codes")
        codes = wire
    return _decode(codes, meta).reshape(shape)


def compress_decompress(cfg: CompressorConfig, g: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One-shot quantization surrogate ``C_b[g]`` (what the server receives)."""
    if cfg.method == "dsgd":
        return g
    meta = plan(cfg, g)
    wire = encode(cfg, g, meta, key)
    return decode(cfg, wire, meta, tuple(g.shape)).to(g.dtype)


def compress_decompress_leaves(cfgs: list, leaves: list, keys: list) -> list:
    """:func:`compress_decompress` of every leaf, leaf i with ``cfgs[i]``
    and ``keys[i]``, bit for bit.  Each leaf keeps its own plan and its own
    uniforms (drawn with its key on its padded tile); the leaves whose
    config sets ``use_pallas`` are encoded together, the codebook ones in
    one segmented K14 launch and the qsgd and tqsgd ones in one segmented
    K12 launch on the card (``kernels.ops.codebook_encode_leaves``,
    ``uniform_encode_leaves``); dsgd leaves pass through."""
    from repro_torch.kernels import ops

    out = list(leaves)
    books, grids = [], []
    for i, (cfg, g, k) in enumerate(zip(cfgs, leaves, keys)):
        if cfg.use_pallas and cfg.method not in _UNIFORM:
            books.append(i)
        elif cfg.use_pallas and cfg.method != "dsgd":
            grids.append(i)
        else:
            out[i] = compress_decompress(cfg, g, k)
    for batch, encode in (
            (books, lambda flats, metas, ks: ops.codebook_encode_leaves(
                flats, [m.levels for m in metas], ks)),
            (grids, lambda flats, metas, ks: ops.uniform_encode_leaves(
                flats, [m.alpha for m in metas], [cfgs[i].bits for i in grids], ks))):
        if not batch:
            continue
        metas = [plan(cfgs[i], leaves[i]) for i in batch]
        flats = [leaves[i].reshape(-1).to(torch.float32) for i in batch]
        codes = encode(flats, metas, [keys[i] for i in batch])
        for i, meta, c in zip(batch, metas, codes):
            out[i] = decode(cfgs[i], _wire(cfgs[i], c), meta,
                            tuple(leaves[i].shape)).to(leaves[i].dtype)
    return out


def tree_compress_decompress(cfg: CompressorConfig, grads: list, key: torch.Tensor) -> list:
    """The two-stage quantizer applied independently to every leaf of a
    gradient list (``models.smallnet.tree_leaves`` order), leaf i with key
    ``split(key, n)[i]``."""
    if cfg.method == "dsgd":
        return list(grads)
    keys = prng.split(key, len(grads))
    return compress_decompress_leaves([cfg] * len(grads), grads, keys)


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


def wire_bits_per_element(cfg: CompressorConfig, n_elements, bits=None) -> float:
    """Effective wire bits per element, metadata included (8·wire_bytes/n)."""
    total = sum(n_elements) if isinstance(n_elements, list | tuple) else n_elements
    return 8.0 * wire_bytes(cfg, n_elements, bits) / max(total, 1)


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
