"""Codec registry — the port of ``repro.core.codecs``.

A codec owns the local halves of the bucketed sync: the per-bucket plan,
the fused encode→pack→residual pass and the fused decode→peer-mean pass,
and the static wire and state geometry.  The sync bodies branch only on
the interface (``chunkable``, ``state_extra``), never on the method name.

Wire contract: one peer's transmission for an n-element bucket is one 1-D
int32 vector of ``wire_words(cfg, n)`` words holding uint32 bit patterns —
for the quantizers ``[packed_size(n, bits) code words][s+1 bitcast float32
levels]``, for ``powersgd`` the bitcast P̂/Q factors (``core.lowrank``).

Codebook methods (nqsgd, tnqsgd) walk the shipped codebook; the uniform
methods (qsgd, tqsgd) encode from α and decode from ``levels[-1]``, through
their own kernels.  A chunkable bucket also splits into ``n_chunks`` peer
chunks for the two-phase reduce-scatter (``encode_chunks``): row j of the
result is a complete wire for chunk j of ``chunk_elems`` elements.

State contract: a bucket's EF row is ``concat(resid, aux)`` of length
``n + state_extra(cfg, n)``; the aux tail is codec memory carried from step
to step (``powersgd``: the warm-started Q factor), empty for the
quantizers.  The quantizers and ``fp16`` (the small-bucket tier: raw
half precision, two values a word) register at import, ``powersgd``
lazily from ``core.lowrank`` on the first lookup.

The module-level ``encode_pack``, ``encode_pack_residual``,
``decode_reduce`` and ``decode_rows`` are the fused per-tensor ops the
per-leaf codec (``bucket_mb=0``) calls with a plan and a wire of its own:
kernels K6/K7, K2/K3, K4/K5 and K8/K9 through ``kernels.ops`` on a card
tensor, their plain versions in ``kernels.ref`` on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from repro_torch.adaptive.telemetry import bucket_statistics
from repro_torch.kernels import ops

from .compressors import METHODS, CompressorConfig, plan_from_stats, wire_bytes
from .quantizers import QuantMeta, packed_size

# Methods whose codebook is the uniform linspace: the kernels encode and
# dequantize them from α alone (code·2α/s − α) instead of a table walk.
_UNIFORM_DECODE = ("qsgd", "tqsgd", "dsgd")


def _encode(cfg: CompressorConfig, op: str, flat: torch.Tensor, meta: QuantMeta,
            key: torch.Tensor, **kw):
    """The uniform or codebook flavour of ``ops.<flavour>_<op>``."""
    if cfg.method in _UNIFORM_DECODE:
        return getattr(ops, f"uniform_{op}")(flat, meta.alpha, cfg.bits, key, **kw)
    return getattr(ops, f"codebook_{op}")(flat, meta.levels, cfg.bits, key, **kw)


def _decode(cfg: CompressorConfig, op: str, words: torch.Tensor, levels: torch.Tensor,
            n: int) -> torch.Tensor:
    """Uniform methods dequantize from α alone (``levels[:, -1]``); the
    rest walk the shipped codebook."""
    if cfg.method in _UNIFORM_DECODE:
        return getattr(ops, f"uniform_{op}")(words, levels[:, -1], n, cfg.bits)
    return getattr(ops, f"codebook_{op}")(words, levels, n, cfg.bits)


def encode_pack(cfg: CompressorConfig, flat: torch.Tensor, meta: QuantMeta,
                key: torch.Tensor) -> torch.Tensor:
    """Flat fp32 -> the ``packed_size(n, bits)`` wire words in one fused
    pass (K6, or K7 for the uniform methods)."""
    return _encode(cfg, "encode_pack", flat, meta, key)


def encode_pack_residual(cfg: CompressorConfig, flat: torch.Tensor, meta: QuantMeta,
                         key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat fp32 -> (wire words, EF residual ``flat − dequant(code)``) in
    one fused pass (K2, or K3)."""
    return _encode(cfg, "encode_pack_residual", flat, meta, key)


def decode_reduce(cfg: CompressorConfig, words: torch.Tensor, levels: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Unpack → dequant → peer mean of gathered wire rows (K4, or K5):
    ``words`` (peers, packed_size(n, bits)), ``levels`` (peers, s+1);
    returns the (n,) fp32 mean."""
    return _decode(cfg, "decode_reduce", words, levels, n)


def decode_rows(cfg: CompressorConfig, words: torch.Tensor, levels: torch.Tensor,
                n: int) -> torch.Tensor:
    """Unpack → dequant of gathered wire rows, one (n,) row per peer (K8,
    or K9): the all-gather phase-2 shape."""
    return _decode(cfg, "decode_rows", words, levels, n)


def _levels_to_wire(levels: torch.Tensor) -> torch.Tensor:
    return levels.to(torch.float32).contiguous().view(torch.int32)


def _levels_from_wire(words: torch.Tensor) -> torch.Tensor:
    return words.contiguous().view(torch.float32)


#: collectives one bucketed sync of a compressed codec may issue, by mode:
#: the count is bounded by the mode, never by the bucket or leaf count
COLLECTIVE_BUDGETS = {
    "faithful": 1,       # one fused all-gather of every peer's wire
    "two_phase": 2,      # all-to-all reduce-scatter + all-gather of chunk wires
    "hierarchical": 3,   # intra-pod two-phase + the cross-pod faithful exchange
}


class Codec:
    """One registered compressor method (see the module docstring).

    The geometry methods (``wire_words``, ``chunk_*``, ``state_extra``)
    return Python ints, fixed by the config and the bucket size.
    """

    name: str = ""
    #: supports the two-phase peer-chunk split (reduce-scatter layout)
    chunkable: bool = True
    #: the method's fidelity knob is ``cfg.rank`` (else ``cfg.bits``)
    rank_based: bool = False
    #: wire bits per element when fixed by the codec, not ``cfg.bits``
    #: (read by ``obs.metrics``)
    fixed_wire_bits: int | None = None

    def plan(self, cfg: CompressorConfig, flat: torch.Tensor, stat):
        """Data-dependent per-bucket plan; opaque to callers."""
        return None

    def collective_budget(self, mode: str, n_buckets: int = 1) -> int:
        """Most collectives one bucketed sync of this codec issues under
        ``mode``: one mean per bucket uncompressed (``dsgd``), else the
        fused-wire budget of :data:`COLLECTIVE_BUDGETS`."""
        if mode == "dsgd" or self.name == "dsgd":
            return int(n_buckets)
        try:
            return COLLECTIVE_BUDGETS[mode]
        except KeyError:
            raise ValueError(f"unknown sync mode {mode!r}; expected one of "
                             f"{tuple(COLLECTIVE_BUDGETS) + ('dsgd',)}") from None

    def wire_words(self, cfg: CompressorConfig, n: int) -> int:
        """int32 words of one peer's full-bucket transmission."""
        raise NotImplementedError

    def wire_bytes(self, cfg: CompressorConfig, n: int) -> int:
        """Accounted wire bytes (the quantizers add their α word)."""
        return 4 * self.wire_words(cfg, n)

    def state_extra(self, cfg: CompressorConfig, n: int) -> int:
        """Aux words appended to the bucket's EF residual row."""
        return 0

    def encode(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
               key: torch.Tensor) -> torch.Tensor:
        """Flat (n,) fp32 -> (wire_words,) wire."""
        raise NotImplementedError

    def encode_residual(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
                        key: torch.Tensor, aux=None):
        """-> (wire, EF residual ``flat − own``, new aux or None)."""
        raise NotImplementedError

    def decode_reduce(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(peers, wire_words) gathered rows -> (n,) fp32 peer mean."""
        raise NotImplementedError

    def decode_rows(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(peers, wire_words) rows -> (peers, n) fp32, one row per peer."""
        raise NotImplementedError

    def chunk_elems(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        raise NotImplementedError

    def chunk_wire_words(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        raise NotImplementedError

    def encode_chunks(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
                      key: torch.Tensor, n_chunks: int):
        """-> ((n_chunks, chunk_wire_words) rows, (n,) EF residual)."""
        raise NotImplementedError


class QuantizerCodec(Codec):
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

    def wire_bytes(self, cfg: CompressorConfig, n: int) -> int:
        return wire_bytes(cfg, n)

    def encode(self, cfg: CompressorConfig, flat: torch.Tensor, pln: QuantMeta,
               key: torch.Tensor) -> torch.Tensor:
        """Flat (n,) fp32 -> (wire_words,) wire."""
        return torch.cat([encode_pack(cfg, flat, pln, key), _levels_to_wire(pln.levels)])

    def encode_residual(self, cfg: CompressorConfig, flat: torch.Tensor, pln: QuantMeta,
                        key: torch.Tensor, aux=None):
        """Flat (n,) fp32 -> (wire, EF residual ``flat − own``, None)."""
        words, resid = encode_pack_residual(cfg, flat, pln, key)
        return torch.cat([words, _levels_to_wire(pln.levels)]), resid, None

    def _split(self, cfg: CompressorConfig, rows: torch.Tensor, n: int):
        w = packed_size(n, cfg.bits)
        return rows[:, :w], _levels_from_wire(rows[:, w:w + cfg.s + 1])

    def decode_reduce(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(peers, wire_words) gathered rows -> (n,) fp32 peer mean."""
        return decode_reduce(cfg, *self._split(cfg, rows, n), n)

    def decode_rows(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """(peers, wire_words) rows -> (peers, n) fp32, one row per peer."""
        return decode_rows(cfg, *self._split(cfg, rows, n), n)

    def chunk_elems(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        # chunks pad to 32 elements so packed chunk words slice cleanly
        return (n + (-n) % (n_chunks * 32)) // n_chunks

    def chunk_wire_words(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        return packed_size(self.chunk_elems(cfg, n, n_chunks), cfg.bits) + cfg.s + 1

    def encode_chunks(self, cfg: CompressorConfig, flat: torch.Tensor, pln: QuantMeta,
                      key: torch.Tensor, n_chunks: int):
        """Flat (n,) -> ((n_chunks, chunk_wire_words) rows, (n,) EF residual).

        One encode pass at code length ``n_chunks·chunk_elems``: the bucket
        is encoded as if zero-padded to it, so the uniforms are drawn on the
        padded tile.  On the card the kernel reads the bucket as it lies."""
        n = n_chunks * self.chunk_elems(cfg, flat.numel(), n_chunks)
        words, resid = _encode(cfg, "encode_pack_residual", flat, pln, key, n=n)
        lv = _levels_to_wire(pln.levels).reshape(1, -1).expand(n_chunks, -1)
        return torch.cat([words.reshape(n_chunks, -1), lv], dim=1), resid


class Fp16Codec(Codec):
    """Raw half precision: the size-adaptive small-bucket tier.

    Buckets of at most ``TrainStepConfig.fp16_threshold`` elements skip
    quantization and ship float16, two values a 32-bit word (the low half
    holds the even element), the bytes of the JAX package's wire.  There
    is no plan and no draw (rounding to nearest even), the EF residual is
    the roundoff ``flat − f32(f16(flat))``, and ``cfg.bits`` is ignored.
    No kernel: the encode is a cast, the words an int16 view of it.
    """

    name = "fp16"
    fixed_wire_bits = 16

    def wire_words(self, cfg: CompressorConfig, n: int) -> int:
        return (n + 1) // 2

    def wire_bytes(self, cfg: CompressorConfig, n: int) -> int:
        return 2 * n

    @staticmethod
    def _pack(flat: torch.Tensor) -> torch.Tensor:
        h = flat.to(torch.float16)
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        return h.contiguous().view(torch.int32)

    @staticmethod
    def _unpack(rows: torch.Tensor, n: int) -> torch.Tensor:
        return rows.contiguous().view(torch.float16)[..., :n].to(torch.float32)

    @staticmethod
    def _roundoff(flat: torch.Tensor) -> torch.Tensor:
        return flat - flat.to(torch.float16).to(torch.float32)

    def encode(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
               key: torch.Tensor) -> torch.Tensor:
        return self._pack(flat)

    def encode_residual(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
                        key: torch.Tensor, aux=None):
        return self._pack(flat), self._roundoff(flat), None

    def decode_reduce(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        """The peers' values added in peer order, times the float32 1/peers
        (``jnp.mean``'s bits): the same bits on the card and on the CPU."""
        vals = self._unpack(rows, n)
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc * (1.0 / vals.shape[0])

    def decode_rows(self, cfg: CompressorConfig, rows: torch.Tensor, n: int) -> torch.Tensor:
        return self._unpack(rows, n)

    def chunk_elems(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        # chunks pad to 2 elements so packed chunk words slice cleanly
        return (n + (-n) % (n_chunks * 2)) // n_chunks

    def chunk_wire_words(self, cfg: CompressorConfig, n: int, n_chunks: int) -> int:
        return self.chunk_elems(cfg, n, n_chunks) // 2

    def encode_chunks(self, cfg: CompressorConfig, flat: torch.Tensor, pln,
                      key: torch.Tensor, n_chunks: int):
        pad = (-flat.numel()) % (n_chunks * 2)
        padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        return self._pack(padded).reshape(n_chunks, -1), self._roundoff(flat)


_REGISTRY: dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Register ``codec`` under ``codec.name``; a second registration of a
    name raises."""
    if not codec.name:
        raise ValueError("codec must set a non-empty name")
    if codec.name in _REGISTRY:
        raise ValueError(f"codec {codec.name!r} is already registered "
                         f"({type(_REGISTRY[codec.name]).__name__})")
    _REGISTRY[codec.name] = codec
    return codec


def _ensure_builtin() -> None:
    # powersgd registers when core.lowrank is imported, which imports this
    # module, so its import waits for the first lookup
    if "powersgd" not in _REGISTRY:
        from . import lowrank  # noqa: F401  (registers powersgd)


def get_codec(method: str) -> Codec:
    """The registered codec for ``method``."""
    _ensure_builtin()
    try:
        return _REGISTRY[method]
    except KeyError:
        raise KeyError(f"no codec registered for method {method!r}; known: "
                       f"{known_methods()}") from None


def known_methods() -> tuple[str, ...]:
    """All registered method names, sorted."""
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


for _m in METHODS:
    register_codec(QuantizerCodec(_m))
del _m
register_codec(Fp16Codec())


def bucket_cfg_entry(cfg: CompressorConfig, entry) -> CompressorConfig:
    """Resolve one per-bucket plan entry to a config: an int (bit width
    under ``cfg.method``), a ``("method", value)`` pair (value = rank for
    rank-based codecs, bits otherwise) or a full config.  Malformed entries
    raise ``ValueError``."""
    if isinstance(entry, CompressorConfig):
        return entry
    if isinstance(entry, tuple | list):
        if len(entry) != 2 or not isinstance(entry[0], str):
            raise ValueError(f"malformed bits_plan entry {entry!r}: a sequence entry must "
                             "be a ('method', value) pair, e.g. ('tqsgd', 3) or "
                             "('powersgd', 2)")
        method, value = entry
        try:
            value = int(value)
        except (TypeError, ValueError):
            raise ValueError(f"malformed bits_plan entry {entry!r}: value must be an int "
                             "(rank for rank-based codecs, bits otherwise)") from None
        field = "rank" if get_codec(method).rank_based else "bits"
        if method == cfg.method and value == getattr(cfg, field):
            return cfg
        return dataclasses.replace(cfg, method=method, **{field: value})
    try:
        entry = int(entry)
    except (TypeError, ValueError):
        raise ValueError(f"malformed bits_plan entry {entry!r}: expected an int bit width, "
                         "a ('method', value) pair, or a CompressorConfig") from None
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
    """The fp16 small-bucket tier over a per-bucket plan: buckets of at
    most ``threshold`` elements become ``("fp16", cfg.bits)``, the rest
    keep their ``plan`` entry (``cfg`` itself when ``plan`` is None).
    ``threshold <= 0``, or no bucket that small, returns ``plan``
    unchanged."""
    if threshold <= 0 or not any(int(m) <= threshold for m in sizes):
        return plan
    base = list(plan) if plan is not None else [cfg] * len(sizes)
    if len(base) != len(sizes):
        raise ValueError(f"bit plan has {len(base)} entries for {len(sizes)} buckets")
    return tuple(("fp16", cfg.bits) if int(m) <= threshold else e for e, m in zip(base, sizes))


def bucket_state_sizes(cfg: CompressorConfig, sizes: Sequence[int],
                       plan: Sequence | None = None) -> list[int]:
    """EF/state row length per bucket: ``m + state_extra`` under the plan."""
    cfgs = bucket_cfgs(cfg, len(sizes), plan)
    return [int(m) + get_codec(c.method).state_extra(c, int(m)) for m, c in zip(sizes, cfgs)]
