"""Sharded wire codec: the per-rank bodies of the compressed sync modes —
the port of ``repro.dist.sharded_codec``.

Every body runs on one rank of a :class:`~repro_torch.dist.compat.Mesh`
and sees only that rank's tensors; the collectives are ``dist.compat``'s
over the axes it is given:

- :func:`two_phase_reduce_scatter_sharded` — phase 1 of two-phase sync:
  quantize each of the n peer-chunks of the local tensor, exchange codes
  all-to-all, dequantize and average (a compressed reduce-scatter);
- :func:`two_phase_mean` — both phases: reduce-scatter, then re-quantize the
  mean chunk and all-gather it back;
- :func:`faithful_ring_mean` — each peer's *full* tensor is quantized
  exactly once and every peer decodes the same n codewords, so all peers
  agree bit for bit on the mean.

Those three are the per-leaf codec (``bucket_mb=0``); each row of a
two-phase chunk is planned by the sort-based ``plan`` and keyed on its own
(:func:`_plan_encode_rows`).  The bucketed bodies
(:func:`bucketed_faithful_ring_mean`, :func:`bucketed_two_phase_mean`,
:func:`bucketed_hierarchical_mean`) take a list of flat fp32 buckets, plan
one codebook per bucket (from the one-pass ``stats`` when given) and fuse
every bucket's wire into one tensor, so each phase issues one collective
whatever the bucket count: faithful one all-gather, two_phase an
all-to-all and an all-gather, hierarchical three.  Every local half goes
through the ``core.codecs`` registry and the bodies branch only on the
codec interface (``chunkable``, the aux state), never on the method: a
non-chunkable codec (``powersgd``) tiles its full wire into every
all-to-all row and is decoded whole in phase 1.  Each body also returns
this rank's state row per bucket: the EF residual ``corrected −
C(corrected)`` from the fused encode, then any codec aux tail.

Peer independence: every encode folds the rank's index over the
collective's own axes into the key (:func:`_peer_key`), so the stochastic
rounding of the peers is independent; the hierarchical cross-pod stage
folds only the pod index, so the members of a pod emit identical bytes.

On the card the local halves run the port's CUDA kernels; the phases are
labelled ``obs.encode``, ``obs.collective`` and ``obs.decode`` for the
profiler (``torch.profiler.record_function``), which changes no numerics.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch.profiler import record_function

from repro_torch.core import prng
from repro_torch.core.codecs import (bucket_cfgs, decode_reduce, decode_rows, encode_pack,
                                     get_codec)
from repro_torch.core.compressors import CompressorConfig, plan
from repro_torch.core.quantizers import QuantMeta

from . import compat


def _peer_key(key: torch.Tensor, mesh: compat.Mesh, axis_name) -> torch.Tensor:
    """The step key decorrelated across the peers of a collective: every rank
    enters with the same key and folds in its index over the collective's
    axes."""
    return prng.fold_in(key, compat.flat_axis_index(mesh, axis_name))


def _plan_encode_rows(cfg: CompressorConfig, rows: torch.Tensor,
                      key: torch.Tensor) -> tuple[torch.Tensor, QuantMeta]:
    """Per-row plan + fused encode-pack: rows (k, m) fp32 -> ((k, words)
    wire words, metas with levels (k, s+1) and alpha (k,))."""
    keys = prng.split(key, rows.shape[0])
    words, metas = [], []
    for r, k in zip(rows, keys):
        meta = plan(cfg, r)
        words.append(encode_pack(cfg, r, meta, k))
        metas.append(meta)
    return torch.stack(words), QuantMeta(levels=torch.stack([m.levels for m in metas]),
                                         alpha=torch.stack([m.alpha for m in metas]))


# Elastic partial participation (``repro_torch.elastic``): each bucketed body
# optionally takes ``live``, a replicated (n,) float32 0/1 mask over the
# collective's peers.  The semantics, identical across modes:
#
# - a dropped peer's encode still runs (the straggler-timeout contract: the
#   codec path is side-effect-free), but its *wire* is zeroed before the
#   collective — a zeroed row decodes to exactly 0.0 for every registered
#   codec (uniform: α=0 ⇒ code·2α/s−α=0; codebook: all-zero levels look up
#   0; low-rank: P=0,Q=0 ⇒ PQᵀ=0; fp16: bits 0 ⇒ 0.0) — so the decode-
#   reduce mean is Σ_live/n and one multiply by ``n / max(n_live, 1)``
#   renormalizes it to the live-peer mean;
# - the dropped peer's EF row keeps the whole corrected bucket
#   (``e ← g + e``, nothing transmitted), so the residual is recovered —
#   not lost — when the peer rejoins;
# - liveness itself is a replicated pure function of ``(seed, step)``
#   (``elastic.schedule.live_mask``) — no mask collective, so the traced
#   collective count per mode is unchanged (REPRO101 budgets hold).
#
# ``live=None`` (the default) skips every masking op: elastic-off graphs
# stay byte-identical to the pre-elastic codec.


def _live_scale(live: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n / max(n_live, 1)`` renormalization of a zero-filled mean."""
    return live.new_full((), float(n)) / torch.clamp_min(torch.sum(live), 1.0)


def _mask_wire(wire: torch.Tensor, self_live) -> torch.Tensor:
    """Zero a dropped peer's wire words (a select on the words; see above)."""
    if self_live is None:
        return wire
    return torch.where(self_live > 0, wire, torch.zeros_like(wire))


def _mask_resid(resid: torch.Tensor, flat: torch.Tensor, self_live) -> torch.Tensor:
    """Dropped peers keep the whole corrected bucket as their EF residual."""
    if self_live is None:
        return resid
    return torch.where(self_live > 0, resid, flat)


def _self_live(live, mesh: compat.Mesh, axis_name, n: int):
    """This rank's own liveness scalar from the replicated (n,) mask."""
    if live is None:
        return None
    return live[compat.flat_axis_index(mesh, axis_name)] if n > 1 else live[0]


# -- the per-leaf codec: one tensor a collective ------------------------------


def two_phase_reduce_scatter_sharded(cfg: CompressorConfig, g: torch.Tensor, dim: int,
                                     mesh: compat.Mesh, axis_name,
                                     key: torch.Tensor) -> torch.Tensor:
    """Compressed reduce-scatter: this rank's chunk of the peer mean.

    The local tensor is split into n equal chunks along ``dim`` (n = the size
    of ``axis_name``); chunk j is planned and quantized on its own and
    shipped to the rank of index j, which decodes the n codewords it
    receives into their mean.
    """
    n = compat.axis_size(mesh, axis_name)
    if n == 1:
        return g
    if g.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(g.shape)} not divisible by axis size {n}")
    key = _peer_key(key, mesh, axis_name)
    c = g.shape[dim] // n
    parts = torch.movedim(g, dim, 0).reshape(n, c, -1)
    flat = parts.reshape(n, -1).to(torch.float32)                     # (n, m)
    words, metas = _plan_encode_rows(cfg, flat, key)
    recv_words = compat.all_to_all_rows(words, mesh, axis_name)       # (n, w)
    recv_levels = compat.all_to_all_rows(metas.levels, mesh, axis_name)
    mean_flat = decode_reduce(cfg, recv_words, recv_levels, flat.shape[1])
    return torch.movedim(mean_flat.reshape((c,) + g.shape[:dim] + g.shape[dim + 1:]), 0, dim)


def two_phase_mean(cfg: CompressorConfig, g: torch.Tensor, mesh: compat.Mesh, axis_name,
                   key: torch.Tensor) -> torch.Tensor:
    """Full two-phase compressed mean: the reduce-scatter, then this rank's
    mean chunk planned afresh, re-quantized and all-gathered."""
    n = compat.axis_size(mesh, axis_name)
    if n == 1:
        return g
    k1, k2 = prng.split(_peer_key(key, mesh, axis_name))
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % n
    padded = torch.cat([flat, flat.new_zeros(pad)])
    chunk = two_phase_reduce_scatter_sharded(cfg, padded, 0, mesh, axis_name, k1)
    # phase 2: broadcast this rank's mean chunk, freshly quantized
    meta2 = plan(cfg, chunk)
    words2 = encode_pack(cfg, chunk, meta2, k2)
    all_words = compat.all_gather_stacked(words2, mesh, axis_name)    # (n, w)
    all_levels = compat.all_gather_stacked(meta2.levels, mesh, axis_name)
    full = decode_rows(cfg, all_words, all_levels, chunk.numel()).reshape(-1)
    return full[:flat.numel()].reshape(g.shape).to(g.dtype)


def faithful_ring_mean(cfg: CompressorConfig, g: torch.Tensor, mesh: compat.Mesh, axis_name,
                       key: torch.Tensor) -> torch.Tensor:
    """Unbiased ring mean: each rank's full tensor is quantized exactly once
    (under its own key when n > 1) and every rank decodes the same n
    codewords, so the result is bitwise equal everywhere."""
    n = compat.axis_size(mesh, axis_name)
    flat = g.reshape(-1).to(torch.float32)
    meta = plan(cfg, flat)
    words = encode_pack(cfg, flat, meta, _peer_key(key, mesh, axis_name) if n > 1 else key)
    if n == 1:
        own = decode_reduce(cfg, words[None], meta.levels[None], flat.numel())
        return own.reshape(g.shape).to(g.dtype)
    all_words = compat.all_gather_stacked(words, mesh, axis_name)     # (n, w)
    all_levels = compat.all_gather_stacked(meta.levels, mesh, axis_name)
    mean_flat = decode_reduce(cfg, all_words, all_levels, flat.numel())
    return mean_flat.reshape(g.shape).to(g.dtype)


# -- the bucketed codec: one fused wire tensor a phase -----------------------


def _state_row(resid: torch.Tensor, aux_new) -> torch.Tensor:
    """One bucket's EF/state row: the residual plus any codec aux tail."""
    return resid if aux_new is None else torch.cat([resid, aux_new])


def _bucket_aux(aux: list | None, b: int):
    return aux[b] if aux is not None else None


def bucketed_faithful_ring_mean(
    cfg: CompressorConfig, buckets: list, mesh: compat.Mesh, axis_name, key: torch.Tensor,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Faithful ring mean over this rank's bucket list with ONE all-gather.

    Each bucket is planned by its codec (from ``stats[b]``, the one-pass
    statistics, or inline) and encoded once under ``fold_in(key', b)``,
    ``key'`` the peer key when n > 1; the buckets' wires are concatenated
    and sliced back by ``codec.wire_words`` after the gather.  ``bits``
    gives per-bucket plan entries, ``aux`` this rank's codec aux tails.
    With ``live`` a dropped rank's wire is zeroed, its residual is its
    corrected bucket, and the mean is renormalized over the live ranks.
    Returns ``(mean_buckets, state_rows)``, row ``b`` ``concat(resid,
    aux_new)``.
    """
    n = compat.axis_size(mesh, axis_name)
    if n > 1:
        key = _peer_key(key, mesh, axis_name)
    self_live = _self_live(live, mesh, axis_name, n)
    scale = None if live is None else _live_scale(live, n)
    cfgs = bucket_cfgs(cfg, len(buckets), bits)
    codecs = [get_codec(c.method) for c in cfgs]
    parts, states, sizes = [], [], []
    with record_function("obs.encode"):
        for b, g in enumerate(buckets):
            flat = g.reshape(-1).to(torch.float32)
            pln = codecs[b].plan(cfgs[b], flat, stats[b] if stats is not None else None)
            wire, resid, aux_new = codecs[b].encode_residual(
                cfgs[b], flat, pln, prng.fold_in(key, b), _bucket_aux(aux, b))
            states.append(_state_row(_mask_resid(resid, flat, self_live), aux_new))
            parts.append(wire)
            sizes.append(flat.numel())
    if n == 1:
        # a single peer: the "mean" is its own transmission, decoded by the
        # same fused decode every multi-peer site uses
        with record_function("obs.decode"):
            means = [codecs[b].decode_reduce(cfgs[b], _mask_wire(parts[b], self_live)[None], m)
                     for b, m in enumerate(sizes)]
            if scale is not None:
                means = [m * scale for m in means]
        return means, states
    with record_function("obs.collective"):
        wire = _mask_wire(torch.cat(parts), self_live)
        rows = compat.all_gather_stacked(wire, mesh, axis_name)         # (n, T)
    with record_function("obs.decode"):
        means, off = [], 0
        for b, m in enumerate(sizes):
            w = codecs[b].wire_words(cfgs[b], m)
            mean_b = codecs[b].decode_reduce(cfgs[b], rows[:, off:off + w], m)
            means.append(mean_b if scale is None else mean_b * scale)
            off += w
    return means, states


def bucketed_two_phase_mean(
    cfg: CompressorConfig, buckets: list, mesh: compat.Mesh, axis_name, key: torch.Tensor,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Two-phase compressed mean over this rank's bucket list: ONE
    all-to-all (phase 1) and ONE all-gather (phase 2) for every bucket.

    With ``k1, k2 = split(peer key)``: a chunkable codec encodes bucket b
    as n chunk rows under ``fold_in(k1, b)``, sharing one plan (from
    ``stats[b]``); row j goes to the rank of index j, which decodes its
    chunk of the mean, plans it afresh, re-encodes it under ``fold_in(k2,
    b)`` and all-gathers it back.  A non-chunkable codec tiles its full wire
    into every row and is decoded whole in phase 1.  ``bits`` and ``aux``
    as in :func:`bucketed_faithful_ring_mean`.  With ``live`` a dropped
    rank zeroes its phase-1 rows and keeps its corrected bucket as
    residual, and the chunk means are renormalized; phase 2, the relay of
    means already averaged, runs unmasked.  Returns ``(mean_buckets,
    state_rows)``; the state rows are phase 1's.
    """
    n = compat.axis_size(mesh, axis_name)
    flats = [g.reshape(-1).to(torch.float32) for g in buckets]
    cfgs = bucket_cfgs(cfg, len(buckets), bits)
    codecs = [get_codec(c.method) for c in cfgs]
    self_live = _self_live(live, mesh, axis_name, n)
    if n == 1:
        # a size-1 axis transmits nothing: the mean is the bucket and the
        # residual zero (a dropped solo member keeps its whole bucket; the
        # hierarchical caller drops it at the cross-pod stage); aux passes
        return flats, [_state_row(torch.zeros_like(f) if self_live is None
                                  else _mask_resid(torch.zeros_like(f), f, self_live),
                                  _bucket_aux(aux, b))
                       for b, f in enumerate(flats)]
    scale = None if live is None else _live_scale(live, n)
    k1, k2 = prng.split(_peer_key(key, mesh, axis_name))
    parts, states, widths = [], [], []
    with record_function("obs.encode"):
        for b, flat in enumerate(flats):
            pln = codecs[b].plan(cfgs[b], flat, stats[b] if stats is not None else None)
            kb = prng.fold_in(k1, b)
            if codecs[b].chunkable:
                rows_b, resid = codecs[b].encode_chunks(cfgs[b], flat, pln, kb, n)
                aux_new = None
            else:
                # the full wire in every all-to-all row: an all-gather riding
                # the same fused tensor, decoded whole in phase 1
                wire_b, resid, aux_new = codecs[b].encode_residual(cfgs[b], flat, pln, kb,
                                                                   _bucket_aux(aux, b))
                rows_b = wire_b[None].expand(n, -1)
            states.append(_state_row(_mask_resid(resid, flat, self_live), aux_new))
            parts.append(rows_b)
            widths.append(rows_b.shape[1])
    with record_function("obs.collective"):
        wire = _mask_wire(torch.cat(parts, dim=1), self_live)            # (n, T1)
        recv = compat.all_to_all_rows(wire, mesh, axis_name)            # (n, T1)

    # phase 1 decode: this rank's chunk of each chunkable bucket's mean, the
    # full mean of a non-chunkable one (every rank holds every wire)
    with record_function("obs.decode"):
        mean_chunks, full_means, off = [], {}, 0
        for b, flat in enumerate(flats):
            rows_b = recv[:, off:off + widths[b]]
            off += widths[b]
            if codecs[b].chunkable:
                mc = codecs[b].chunk_elems(cfgs[b], flat.numel(), n)
                ch = codecs[b].decode_reduce(cfgs[b], rows_b, mc)
                mean_chunks.append(ch if scale is None else ch * scale)
            else:
                fm = codecs[b].decode_reduce(cfgs[b], rows_b, flat.numel())
                full_means[b] = fm if scale is None else fm * scale
                mean_chunks.append(None)

    # phase 2: re-encode the mean chunks, one fused all-gather back (none
    # when no bucket chunks)
    parts2, widths2 = [], []
    with record_function("obs.encode"):
        for b, ch in enumerate(mean_chunks):
            if ch is None:
                widths2.append(0)
                continue
            pln2 = codecs[b].plan(cfgs[b], ch, None)
            parts2.append(codecs[b].encode(cfgs[b], ch, pln2, prng.fold_in(k2, b)))
            widths2.append(parts2[-1].shape[0])
    rows2 = None
    if parts2:
        with record_function("obs.collective"):
            rows2 = compat.all_gather_stacked(torch.cat(parts2), mesh, axis_name)  # (n, T2)
    with record_function("obs.decode"):
        means, off = [], 0
        for b, flat in enumerate(flats):
            if mean_chunks[b] is None:
                means.append(full_means[b])
                continue
            mc = mean_chunks[b].numel()
            vals = codecs[b].decode_rows(cfgs[b], rows2[:, off:off + widths2[b]], mc)
            off += widths2[b]
            means.append(vals.reshape(n * mc)[:flat.numel()])          # row j = chunk j
    return means, states


def bucketed_hierarchical_mean(
    cfg: CompressorConfig, buckets: list, mesh: compat.Mesh, dp: tuple, key: torch.Tensor,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Two-phase inside the innermost data axis, faithful exchange of the
    pod means across the leading pod axes: 3 collectives.

    With ``k1, k2 = split(key)``, the intra-pod stage enters with ``k1``
    folded by the rank's full dp index (same-data-rank peers of different
    pods encode different data), the cross-pod stage with ``k2`` (folded
    by the pod index only: a pod's members emit identical bytes), planning
    the pod means inline with no codec aux.  The state rows are the
    intra-pod stage's.  With ``live``, the pod's stage takes its row of
    ``live.reshape(n_pod, nd)`` and the cross-pod stage the pods' max: a
    pod is live if any member is, and pods weigh equally.
    """
    pod_axes, data_axis = tuple(dp[:-1]), tuple(dp[-1:])
    k1, k2 = prng.split(key)
    k1 = _peer_key(k1, mesh, tuple(dp))
    live_sub = pod_live = None
    if live is not None:
        mat = live.reshape(compat.axis_size(mesh, pod_axes), compat.axis_size(mesh, data_axis))
        live_sub = mat[compat.flat_axis_index(mesh, pod_axes)]
        pod_live = torch.amax(mat, dim=1)
    means, states = bucketed_two_phase_mean(cfg, buckets, mesh, data_axis, k1, bits, stats, aux,
                                            live_sub)
    means, _ = bucketed_faithful_ring_mean(cfg, means, mesh, pod_axes, k2, bits, live=pod_live)
    return means, states
