"""Analytic wire accounting for the gradient-sync collectives — the port
of ``repro.dist.collectives``: pure Python over ``core.compressors`` and
the codec registry, every count equal to the JAX package's.

``wire_bytes_per_device(cfg, n, shards, mode)`` returns the bytes one device
puts on the wire **per hop of a bandwidth-optimal ring schedule** for one
n-element gradient sync over ``shards`` devices.  Per-hop payload is the
right unit for roofline math: a ring schedule runs ``O(shards)`` hops
back-to-back, so step latency on the interconnect is ``hops × per-hop
bytes / link bandwidth``, and the per-hop payload is what each link carries
at any instant.

- ``dsgd``          — fp32 ring all-reduce: each hop moves one fp32 chunk,
                      ``4 · n / shards`` bytes (reduce-scatter and all-gather
                      phases have identical per-hop cost);
- ``two_phase``     — both phases move one *quantized* chunk + its codebook:
                      ``wire_bytes(cfg, ceil(n/shards))``;
- ``faithful``      — chunk-pipelined ring all-gather of each peer's full
                      quantized tensor: ``wire_bytes(cfg, n) / shards`` per
                      hop (codebooks amortized over the ring);
- ``hierarchical``  — two-phase inside the pod plus the cross-pod faithful
                      exchange of the pod mean amortized over pod members.

The compression ratio vs fp32 is therefore ~``32 / bits`` for two_phase and
faithful — independent of ``shards`` — matching the paper's wire model.

Elastic accounting: every function accepts ``live`` (the number of peers
actually contributing gradients this step).  ``wire_bytes_per_device``
scales pro-rata by ``live / shards`` — dead peers ship a zeroed wire row
whose bytes never traverse their links, and the two-phase relay is
attributed to the contributions it carries; ``decode_hbm_bytes`` decodes
``live`` meaningful rows; ``encode_hbm_bytes`` is *unchanged* by ``live``
(the straggler contract: every peer's encode runs even when its wire is
masked, so the encode-side HBM traffic is paid regardless).
"""
from __future__ import annotations

from repro_torch.core.compressors import METHODS, CompressorConfig

MODES = ("dsgd", "two_phase", "hierarchical", "faithful")


def _check_live(live, shards: int) -> None:
    if live is not None and not 1 <= live <= shards:
        raise ValueError(f"live peer count {live} outside [1, {shards}]")


def _plan_entry(bits):
    """True for a ``("method", value)`` plan entry or a full config."""
    if isinstance(bits, CompressorConfig):
        return True
    return (isinstance(bits, tuple | list) and len(bits) == 2
            and isinstance(bits[0], str))


def _bucket_cfg(cfg: CompressorConfig, bits) -> CompressorConfig:
    """Resolve a per-bucket plan entry (int bits / method tuple / config)
    against the base config; plain ``None``/int keep the quantizer path."""
    from repro_torch.core.codecs import bucket_cfg_entry

    return cfg if bits is None else bucket_cfg_entry(cfg, bits)


def wire_bytes_per_device(cfg: CompressorConfig, n, shards: int, mode: str, bits=None,
                          live: int | None = None) -> float:
    """Per-device, per-hop wire bytes for one n-element gradient sync.

    ``n`` may be a sequence of per-bucket sizes with a matching sequence of
    per-bucket ``bits`` entries — plain bit widths or ``("method", value)``
    codec-plan entries (the adaptive fused wire format); the cost is then
    the sum over buckets, each chunked per the mode.  Codecs without
    chunk-aligned wires (rank-based factor pairs) put an indivisible wire
    on the all-to-all rows, so their two-phase cost is the full wire.

    ``live`` (elastic): with ``k`` of ``shards`` peers contributing, each
    link carries ``k/shards`` of the full-participation payload — dead
    peers' zeroed rows never leave their HBM, and the two-phase phase-2
    relay (structural, always on) is attributed pro-rata to the live
    contributions it forwards.
    """
    if isinstance(n, list | tuple):
        bl = bits if isinstance(bits, list | tuple) and not _plan_entry(bits) \
            else [bits] * len(n)
        if len(bl) != len(n):
            raise ValueError(f"{len(bl)} bit-widths vs {len(n)} buckets")
        return sum(wire_bytes_per_device(cfg, nb, shards, mode, b, live)
                   for nb, b in zip(n, bl))
    if mode not in MODES:
        raise ValueError(f"unknown sync mode {mode!r}; expected one of {MODES}")
    if shards < 1:
        raise ValueError("shards must be >= 1")
    _check_live(live, shards)
    frac = 1.0 if live is None else live / shards
    if mode == "dsgd" or cfg.method == "dsgd":
        return frac * 4.0 * n / shards
    bcfg = _bucket_cfg(cfg, bits)
    from repro_torch.core.codecs import get_codec

    codec = get_codec(bcfg.method)
    if not codec.chunkable:
        full = float(codec.wire_bytes(bcfg, n))
        if mode == "two_phase":
            base = full          # full wire tiled into every all-to-all row
        elif mode == "faithful":
            base = full / shards
        else:
            base = full + full / shards
        return frac * base
    # analytic ceil chunk (the codec's actual chunk_elems pads a little
    # further for pack alignment; the model ignores that sub-percent slack)
    chunk = -(-n // shards)
    if mode == "two_phase":
        return frac * float(codec.wire_bytes(bcfg, chunk))
    if mode == "faithful":
        return frac * codec.wire_bytes(bcfg, n) / shards
    # hierarchical: intra-pod two-phase chunk + the pod-mean faithful
    # exchange across pods, spread over the pod's members.
    return frac * (float(codec.wire_bytes(bcfg, chunk))
                   + codec.wire_bytes(bcfg, n) / shards)


def decode_hbm_bytes(cfg: CompressorConfig, n, peers: int, fused: bool, bits=None,
                     live: int | None = None) -> float:
    """HBM bytes one device moves to decode + average ``peers`` gathered
    n-element wire rows (the decode half of ``faithful`` / the reduce side of
    ``two_phase``).

    - unfused (the pre-fusion ``vmap(unpack_codes)`` → ``take`` → ``mean``
      path): reads the packed words, then writes *and re-reads* the
      (peers, n) int32 unpacked code tensor and the (peers, n) fp32
      dequantized tensor before reducing to the (n,) output;
    - fused (``kernels.decode``): reads the packed words once and writes the
      (n,) mean once — codes and values never leave the chip.

    Both include the per-peer codebook reads.  ``n``/``bits`` may be
    per-bucket sequences (the adaptive fused wire format); the cost sums.
    ``live`` (elastic) overrides the row multiplier: only ``live`` of the
    gathered rows carry meaningful payload, so
    ``decode_hbm_bytes(cfg, n, peers, fused, live=k) ==
    decode_hbm_bytes(cfg, n, k, fused)``.
    """
    _check_live(live, peers)
    if live is not None:
        peers = live
    if isinstance(n, list | tuple):
        bl = bits if isinstance(bits, list | tuple) and not _plan_entry(bits) \
            else [bits] * len(n)
        if len(bl) != len(n):
            raise ValueError(f"{len(bl)} bit-widths vs {len(n)} buckets")
        return sum(decode_hbm_bytes(cfg, nb, peers, fused, b) for nb, b in zip(n, bl))
    from repro_torch.core.codecs import get_codec

    bcfg = _bucket_cfg(cfg, bits)
    # The registry is the single source of truth for wire geometry: one
    # (wire_words,) uint32 row per peer — packed codes + bitcast codebook
    # for the quantizers, the bitcast factor pair for rank-based codecs,
    # packed half words for the fp16 tier.
    words = 4.0 * peers * get_codec(bcfg.method).wire_words(bcfg, n)
    if bcfg.method not in METHODS:
        # Registry codecs without an unpack-codes pass (rank-based factor
        # reconstruction, the fp16 bitcast): read every peer's row,
        # materialize the per-peer (n,) values (fused keeps them on chip;
        # unfused writes + re-reads them before the mean).
        if fused:
            return words + 4.0 * n
        return words + 2 * 4.0 * peers * n + 4.0 * n
    if fused:
        return words + 4.0 * n
    return words + 2 * 4.0 * peers * n + 2 * 4.0 * peers * n + 4.0 * n


def encode_hbm_bytes(cfg: CompressorConfig, n, fused: bool, *, ef: bool = True,
                     adaptive: bool = True, bits=None,
                     live: int | None = None) -> float:
    """HBM bytes one device moves to turn an n-element gradient bucket into
    wire words + next EF residual (the encode half of every sync mode).

    The model covers the encode pipeline from corrected-gradient formation
    through residual write-back; the leaf→bucket coalescing copy is
    identical in both layouts and excluded from both.

    - unfused (the pre-fusion path): the leaf-wise EF add (read g, read e,
      write corrected), a telemetry statistics sweep (``adaptive``), the
      ``plan()`` statistics pass — a subsample gather plus an
      O(s·log s) sort for the exact quantile (``cfg.approx_gmin`` swaps the
      sort for ~2 extra histogram passes over the sample), the encode (read
      corrected, write uint8 codes), a separate ``pack_codes`` pass (read
      codes, write words), the own-dequantization (read codes, write fp32
      owns), the ``corrected − owns`` residual (read both, write), the
      ``bucket_split`` of the residual back to leaf layout, and the
      leaf-pytree EF restack/constraint round-trip on the next step;
    - fused (``kernels.encode_fused``): ``ef_correct_stats`` reads g and e
      once and writes the corrected bucket (statistics stay on chip — the
      telemetry sweep and the whole ``plan()`` pass disappear into it), and
      ``encode_pack_residual`` reads the corrected bucket and writes the
      wire words + the bucket-resident residual.  Codes and owns never
      reach HBM, and the EF state needs no split/restack.

    ``ef=False`` drops the correction/residual terms on both sides (the
    fused side still pays the full-bucket stats read that replaces the
    subsampled sort — better statistics for strictly fewer bytes only once
    the EF/telemetry sweeps are in play).  ``n``/``bits`` may be per-bucket
    sequences (the heterogeneous adaptive wire); the cost sums.

    ``live`` is accepted for signature symmetry but **does not change the
    cost**: the elastic straggler contract keeps every peer's encode
    running (masking happens on the wire tensor afterwards), so the
    encode-side HBM traffic is paid whether or not the peer is live.
    """
    del live  # encode always runs — see the docstring
    if isinstance(n, list | tuple):
        bl = bits if isinstance(bits, list | tuple) and not _plan_entry(bits) \
            else [bits] * len(n)
        if len(bl) != len(n):
            raise ValueError(f"{len(bl)} bit-widths vs {len(n)} buckets")
        return sum(encode_hbm_bytes(cfg, nb, fused, ef=ef, adaptive=adaptive, bits=b)
                   for nb, b in zip(n, bl))
    from math import ceil, log2

    from repro_torch.core.codecs import get_codec

    bcfg = _bucket_cfg(cfg, bits)
    codec = get_codec(bcfg.method)
    if bcfg.method not in METHODS and codec.chunkable:
        # Plan-less passthrough (fp16): one cast+pack sweep — read g
        # (+ the EF read/write when on), write the packed half words,
        # write the cast residual.  One pass, fused == unfused.
        words = 4.0 * codec.wire_words(bcfg, n)
        total = 4.0 * n
        if ef:
            total += 8.0 * n
        total += words
        if ef:
            total += 4.0 * n
        return total
    if bcfg.method not in METHODS:
        # Rank-based encode: EF-correct sweep, two power-iteration matmul
        # reads of the bucket, the factor-pair wire write, the own
        # reconstruction, and the residual write-back.  The factorization
        # is the same either way, so fused == unfused here.
        words = 4.0 * codec.wire_words(bcfg, n)
        total = 4.0 * n                      # stats/correct: read g
        if ef:
            total += 8.0 * n                 # ... read e, write corrected
        total += 2 * 4.0 * n + words         # M@Q and M.T@P reads + wire
        total += 4.0 * n                     # own P@Q.T reconstruction
        if ef:
            total += 4.0 * n                 # residual write-back
        return total
    # packed code words only: the codebook rides the registry wire row
    # (wire_words = packed + s + 1) but is written straight from the kernel
    words = 4.0 * (get_codec(bcfg.method).wire_words(bcfg, n) - (bcfg.s + 1))
    if fused:
        total = 4.0 * n                      # ef_correct_stats: read g
        if ef:
            total += 8.0 * n                 # ... read e, write corrected
        total += 4.0 * n + words             # encode_pack: read corrected, write wire
        if ef:
            total += 4.0 * n                 # ... write bucket-resident residual
        return total
    s = min(n, cfg.plan_sample) if cfg.plan_sample else n
    plan_pass = 4.0 * s * 3 if cfg.approx_gmin \
        else 4.0 * s * (1 + 2 * max(ceil(log2(max(s, 2))), 1))  # gather + hists/sort
    total = plan_pass + 4.0 * n + 1.0 * n + 1.0 * n + words   # encode + pack passes
    if adaptive:
        total += 4.0 * n                     # standalone telemetry stats sweep
    if ef:
        total += 12.0 * n                    # leaf-wise EF add: read g, read e, write c
        total += 1.0 * n + 4.0 * n           # own-decode: read codes, write owns
        total += 12.0 * n                    # residual: read c + owns, write resid
        total += 8.0 * n                     # bucket_split of the residual
        total += 8.0 * n                     # leaf EF restack/constraint round-trip
    return total
