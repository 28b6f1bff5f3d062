"""Single-device reference of the gradient sync.

The port of ``repro.dist.reference``: the collectives of the mesh sync are
replaced by indexing over a stacked peer axis on one device.

The bucketed codec (``bucket_mb > 0``): every peer's bucket is
EF-corrected with its one-pass statistics (``correct_stats``), planned
from those statistics and encoded under the peer's and bucket's folded
key.

- faithful: every peer's full wire is decoded into the peer mean (the
  all-gather);
- two_phase: each peer encodes its bucket as n chunk wires; chunk j of
  every peer is decoded into mean chunk j (the all-to-all reduce-scatter),
  which is planned afresh, re-encoded and decoded row by row into the full
  mean (the all-gather).  A codec that is not chunkable (``powersgd``)
  ships its full wire instead, and every peer's is decoded in phase 1;
- hierarchical: two_phase inside each pod, then faithful across the pod
  means, with no codec aux (a cold PowerSGD start).

An EF row is the residual followed by the codec's aux tail (``powersgd``:
the warm-started Q factor; none for the quantizers).  With ``tstate`` the
peers' telemetry rows fold in the statistics the sync computed.

Elastic participation (``live``, an (n,) float32 0/1 mask from
``elastic.live_mask``): every ``live=`` branch applies the mesh bodies' own
helpers (``sc._mask_wire``, ``sc._mask_resid``, ``sc._live_scale``) to the
same operands.  A dropped peer still encodes, but its wire is zeroed and
its EF row keeps its whole corrected bucket; the zero-filled mean is
renormalized by ``n / max(n_live, 1)``.  two_phase masks phase 1 and
scales the chunk means, and its phase 2 runs unmasked; hierarchical
gives pod p row p of ``live.reshape(n_pod, nd)`` and the cross-pod stage
the pods' max, so a fully dead pod drops out and pods weigh equally.
With ``ts.metrics_compression`` the replay also returns every peer's
``obs.metrics.CompressionMetrics``.

The per-leaf codec (``bucket_mb=0``, :func:`reference_sync`): every leaf
is synced on its own with the sort-based plan of each tensor it encodes
(``faithful_ring_mean``, ``two_phase_mean``, ``hierarchical_mean``), under
``fold_in(key, leaf)``; no error feedback, no telemetry, no live mask.

On the card every step runs the port's CUDA kernels; on the CPU their
plain versions.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.adaptive import telemetry
from repro_torch.core import compressors, prng
from repro_torch.core.codecs import (bucket_cfgs, decode_reduce, decode_rows, encode_pack,
                                     get_codec, size_adaptive_plan)
from repro_torch.core.compressors import CompressorConfig, plan
from repro_torch.obs import metrics as obs_metrics

from . import sharded_codec as sc


def _peer_stats(buckets: list, stats: list | None) -> list:
    """``stats[i][b]``: peer i's one-pass statistics of bucket b."""
    if stats is not None:
        return stats
    n = buckets[0].shape[0]
    return [[telemetry.bucket_statistics(sb[i].to(torch.float32)) for sb in buckets]
            for i in range(n)]


def _state_row(resid: torch.Tensor, aux_new) -> torch.Tensor:
    """One bucket's EF row: the residual plus any codec aux tail."""
    return resid if aux_new is None else torch.cat([resid, aux_new])


def _peer_aux(aux: list | None, b: int, i: int):
    """Peer i's aux tail of bucket b, or None."""
    return aux[b][i] if aux is not None and aux[b] is not None else None


def _in_keys(key, n: int) -> list:
    """Per-peer incoming keys: one key for every peer, or the per-peer list
    the hierarchical intra-pod stage hands in, already folded."""
    return list(key) if isinstance(key, list | tuple) else [key] * n


def _fold(key: torch.Tensor, i: int) -> torch.Tensor:
    """The key of the peer whose flat axis index is ``i``."""
    return prng.fold_in(key, i)


# -- the per-leaf codec (bucket_mb=0) ----------------------------------------


def faithful_ring_mean(cfg: CompressorConfig, stacked: torch.Tensor, key) -> torch.Tensor:
    """Faithful mean of ``stacked`` (n, m) per-peer tensors: peer i plans
    its tensor, encodes it under ``fold_in(key_i, i)`` (its incoming key
    itself when n == 1) and every peer's wire is decoded into the mean."""
    n = stacked.shape[0]
    keys = _in_keys(key, n)
    words, levels = [], []
    for i in range(n):
        flat = stacked[i].reshape(-1).to(torch.float32)
        meta = plan(cfg, flat)
        words.append(encode_pack(cfg, flat, meta, keys[0] if n == 1 else _fold(keys[i], i)))
        levels.append(meta.levels)
    return decode_reduce(cfg, torch.stack(words), torch.stack(levels), stacked[0].numel())


def two_phase_mean(cfg: CompressorConfig, stacked: torch.Tensor, key) -> torch.Tensor:
    """Two-phase mean of ``stacked`` (n, size): a compressed reduce-scatter,
    then a compressed all-gather, the same on every peer.

    Peer i's incoming key is folded by i and split: ``[0]`` folded by i
    keys its n chunk rows (the tensor zero-padded to n·m, m = ceil(size/n),
    each row planned and keyed on its own), ``[1]`` its re-encode of mean
    chunk i, planned afresh.
    """
    n, size = stacked.shape
    if n == 1:
        return stacked[0]
    keys = [prng.split(_fold(k, j)) for j, k in enumerate(_in_keys(key, n))]
    pad = (-size) % n
    m = (size + pad) // n
    # phase 1 (reduce-scatter): peer i packs its n chunk rows; peer j
    # decodes row j of every peer (the all-to-all transpose) into its chunk
    words, levels = [], []
    for i in range(n):
        flats = torch.cat([stacked[i].to(torch.float32),
                           stacked.new_zeros(pad, dtype=torch.float32)]).reshape(n, m)
        w, metas = sc._plan_encode_rows(cfg, flats, _fold(keys[i][0], i))
        words.append(w)
        levels.append(metas.levels)
    chunks = [decode_reduce(cfg, torch.stack([w[j] for w in words]),
                            torch.stack([lv[j] for lv in levels]), m) for j in range(n)]
    # phase 2 (all-gather): each peer re-quantizes its mean chunk
    words2, levels2 = [], []
    for j in range(n):
        meta2 = plan(cfg, chunks[j])
        words2.append(encode_pack(cfg, chunks[j], meta2, keys[j][1]))
        levels2.append(meta2.levels)
    full = decode_rows(cfg, torch.stack(words2), torch.stack(levels2), m)
    return full.reshape(n * m)[:size]


def hierarchical_mean(cfg: CompressorConfig, stacked: torch.Tensor, n_pod: int,
                      key: torch.Tensor) -> torch.Tensor:
    """Two-phase inside each pod's data axis (peer d of pod p enters with
    ``fold_in(k1, p·nd + d)``), faithful across the pod means under k2,
    where ``k1, k2 = split(key)``."""
    n = stacked.shape[0]
    nd = n // n_pod
    k1, k2 = prng.split(key)
    pod_means = [two_phase_mean(cfg, stacked[p * nd:(p + 1) * nd],
                                [_fold(k1, p * nd + d) for d in range(nd)])
                 for p in range(n_pod)]
    return faithful_ring_mean(cfg, torch.stack(pod_means), k2)


# -- the bucketed codec -------------------------------------------------------


def bucketed_faithful_ring_mean(
    cfg: CompressorConfig, buckets: list, key,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Faithful ring mean over stacked (n, m_b) buckets.

    Peer i encodes bucket b under ``fold_in(fold_in(key_i, i), b)`` (the
    per-peer fold only when n > 1); ``aux[b]`` (optional) stacks the
    peers' codec aux tails (n, extra_b).  With ``live``, each dropped
    peer's wire is zeroed and its residual is its corrected bucket, and
    the mean is renormalized over the live peers.  Returns
    ``(mean_buckets, state_stacked)`` with ``state_stacked[b]`` the (n,
    m_b + extra_b) per-peer EF rows (residual, then the new aux).
    """
    n = buckets[0].shape[0]
    keys = _in_keys(key, n)
    keys = [prng.fold_in(k, i) for i, k in enumerate(keys)] if n > 1 else keys
    cfgs = bucket_cfgs(cfg, len(buckets), bits)
    codecs = [get_codec(c.method) for c in cfgs]
    stats = _peer_stats(buckets, stats)
    scale = None if live is None else sc._live_scale(live, n)
    means, states = [], []
    for b, sb in enumerate(buckets):
        wires, rows = [], []
        for i in range(n):
            flat = sb[i].to(torch.float32)
            pln = codecs[b].plan(cfgs[b], flat, stats[i][b])
            w, r, a = codecs[b].encode_residual(cfgs[b], flat, pln, prng.fold_in(keys[i], b),
                                                _peer_aux(aux, b, i))
            if live is not None:
                w = sc._mask_wire(w, live[i])
                r = sc._mask_resid(r, flat, live[i])
            wires.append(w)
            rows.append(_state_row(r, a))
        states.append(torch.stack(rows))
        mean_b = codecs[b].decode_reduce(cfgs[b], torch.stack(wires), sb.shape[1])
        means.append(mean_b if scale is None else mean_b * scale)
    return means, states


def bucketed_two_phase_mean(
    cfg: CompressorConfig, buckets: list, key,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Two-phase mean over stacked (n, m_b) buckets.

    Peer i's incoming key is folded by i and split: ``[0]`` folded by b
    keys its phase-1 chunk encode of bucket b, ``[1]`` folded by b its
    phase-2 re-encode of mean chunk i.  The phase-2 plans come from each
    mean chunk's own statistics.  A bucket whose codec is not chunkable
    is encoded whole with its aux tail (``aux`` as in
    :func:`bucketed_faithful_ring_mean`) and every peer's wire decoded in
    phase 1, with no phase 2.  With ``live``, phase 1 masks the dropped
    peers' wires and residuals and the chunk means (or a non-chunkable
    codec's full mean) are renormalized; phase 2, the relay of means
    already averaged, runs unmasked.  Returns ``(mean_buckets,
    state_stacked)``; the EF rows are the phase-1 residuals and aux tails.
    """
    n = buckets[0].shape[0]
    cfgs = bucket_cfgs(cfg, len(buckets), bits)
    codecs = [get_codec(c.method) for c in cfgs]
    if n == 1:
        flats = [sb[0].to(torch.float32) for sb in buckets]
        return flats, [_state_row(torch.zeros_like(f) if live is None
                                  else sc._mask_resid(torch.zeros_like(f), f, live[0]),
                                  _peer_aux(aux, b, 0))[None]
                       for b, f in enumerate(flats)]
    keys = [prng.split(prng.fold_in(k, j)) for j, k in enumerate(_in_keys(key, n))]
    stats = _peer_stats(buckets, stats)
    scale = None if live is None else sc._live_scale(live, n)
    means, states = [], []
    for b, sb in enumerate(buckets):
        size = sb.shape[1]
        wires, rows = [], []
        for i in range(n):
            flat = sb[i].to(torch.float32)
            pln = codecs[b].plan(cfgs[b], flat, stats[i][b])
            ki = prng.fold_in(keys[i][0], b)
            if codecs[b].chunkable:
                w, r = codecs[b].encode_chunks(cfgs[b], flat, pln, ki, n)
                a = None
            else:
                w, r, a = codecs[b].encode_residual(cfgs[b], flat, pln, ki, _peer_aux(aux, b, i))
            if live is not None:
                w = sc._mask_wire(w, live[i])
                r = sc._mask_resid(r, flat, live[i])
            wires.append(w)
            rows.append(_state_row(r, a))
        states.append(torch.stack(rows))
        if not codecs[b].chunkable:
            # the full wire in every all-to-all row is an all-gather: every
            # peer decodes the same stacked wires into the full mean
            fm = codecs[b].decode_reduce(cfgs[b], torch.stack(wires), size)
            means.append(fm if scale is None else fm * scale)
            continue
        mc = codecs[b].chunk_elems(cfgs[b], size, n)
        chunks = [codecs[b].decode_reduce(cfgs[b], torch.stack([w[j] for w in wires]), mc)
                  for j in range(n)]
        if scale is not None:
            chunks = [ch * scale for ch in chunks]
        wires2 = [codecs[b].encode(cfgs[b], chunks[j], codecs[b].plan(cfgs[b], chunks[j], None),
                                   prng.fold_in(keys[j][1], b))
                  for j in range(n)]
        vals = codecs[b].decode_rows(cfgs[b], torch.stack(wires2), mc)
        means.append(vals.reshape(n * mc)[:size])
    return means, states


def bucketed_hierarchical_mean(
    cfg: CompressorConfig, buckets: list, n_pod: int, key: torch.Tensor,
    bits: Sequence | None = None, stats: list | None = None, aux: list | None = None,
    live: torch.Tensor | None = None,
) -> tuple[list, list]:
    """Two-phase inside each pod, faithful across the pod means.

    With ``k1, k2 = split(key)``, peer d of pod p enters its pod's
    two-phase stage with ``fold_in(k1, p·nd + d)`` (the full dp index); the
    cross-pod faithful stage gets ``k2`` and plans from the pod means' own
    statistics, with no codec aux.  The EF rows (residuals and aux tails)
    are the intra-pod stage's: pod p gets the aux rows of its own peers.
    With ``live``, pod p's stage takes row p of ``live.reshape(n_pod, nd)``
    and the cross-pod stage the pods' max: a pod is live if any of its
    peers is, so a fully dead pod drops out and pods weigh equally.
    """
    n = buckets[0].shape[0]
    nd = n // n_pod
    k1, k2 = prng.split(key)
    stats = _peer_stats(buckets, stats)
    mat = None if live is None else live.reshape(n_pod, nd)
    pod_means, pod_resids = [], []
    for p in range(n_pod):
        in_keys = [prng.fold_in(k1, p * nd + d) for d in range(nd)]
        aux_p = None if aux is None else [a if a is None else a[p * nd:(p + 1) * nd]
                                          for a in aux]
        m, r = bucketed_two_phase_mean(cfg, [sb[p * nd:(p + 1) * nd] for sb in buckets],
                                       in_keys, bits, stats[p * nd:(p + 1) * nd], aux_p,
                                       None if mat is None else mat[p])
        pod_means.append(m)
        pod_resids.append(r)
    stacked = [torch.stack([pod_means[p][b] for p in range(n_pod)]) for b in range(len(buckets))]
    pod_live = None if mat is None else torch.amax(mat, dim=1)
    means, _ = bucketed_faithful_ring_mean(cfg, stacked, k2, bits, live=pod_live)
    resids = [torch.cat([pod_resids[p][b] for p in range(n_pod)]) for b in range(len(buckets))]
    return means, resids


def reference_sync_state(ts, stacked_leaves: list, dp_sizes: tuple, key: torch.Tensor,
                         ef=None, tstate=None, live=None):
    """Bucketed sync of every peer on one device.

    ``stacked_leaves``: one (n, *leaf_shape) fp32 tensor per gradient leaf,
    in ``jax.tree.leaves`` order; ``dp_sizes``: the data-parallel axis
    sizes (their product is n); ``ef``: a list of stacked (n, m_b)
    bucket-resident residuals, or None; ``tstate``: a per-peer stacked
    :class:`~repro_torch.adaptive.telemetry.TelemetryState` (leaves with a
    leading axis n), or None; ``live``: an (n,) float32 0/1 live mask, or
    None (everyone live).  Returns ``(mean_leaves, resid_stacked | None,
    new_tstate | None, metrics | None)``.  The telemetry rows fold in the
    statistics of the corrected buckets the sync computes (K1 with EF,
    else K10), with the decay ``ts.adaptive.ema``.  ``metrics`` (under
    ``ts.metrics_compression``) is every peer's
    :class:`~repro_torch.obs.metrics.CompressionMetrics`, leaves stacked
    (n, n_buckets): peer j's from its corrected buckets, statistics,
    masked residual rows and incoming EF rows.
    """
    cfg = ts.compressor
    n = 1
    for s in dp_sizes:
        n *= s
    n_pod = n // dp_sizes[-1]
    shapes = [tuple(x.shape[1:]) for x in stacked_leaves]
    bp = compressors.plan_buckets([x[0].numel() for x in stacked_leaves], ts.bucket_elements)
    per_peer = [compressors.bucket_concat([x[j] for x in stacked_leaves], bp) for j in range(n)]
    compressed = not (ts.sync == "dsgd" or cfg.method == "dsgd")
    bits = size_adaptive_plan(cfg, ts.bits_plan, bp.sizes, ts.fp16_threshold)
    # split each EF row into the residual and the codec's aux tail
    cfgs = bucket_cfgs(cfg, bp.n_buckets, bits)
    extras = [get_codec(c.method).state_extra(c, m) for c, m in zip(cfgs, bp.sizes)]
    aux = None
    if ef is not None and any(extras):
        aux = [ef[b][:, bp.sizes[b]:] if x else None for b, x in enumerate(extras)]
        ef = [ef[b][:, :bp.sizes[b]] if x else ef[b] for b, x in enumerate(extras)]
    stats = None
    if compressed or tstate is not None:
        stats = []
        for j in range(n):
            row, srow = [], []
            for b, g in enumerate(per_peer[j]):
                c, st = telemetry.correct_stats(g, ef[b][j] if ef is not None else None)
                row.append(c)
                srow.append(st)
            per_peer[j] = row
            stats.append(srow)
    new_t = None
    if tstate is not None:
        rows = [telemetry.update_telemetry(telemetry.peer_row(tstate, j), per_peer[j],
                                           decay=ts.adaptive.ema, stats=stats[j])
                for j in range(n)]
        new_t = telemetry.stack_rows(rows)
    buckets = [torch.stack([per_peer[j][b] for j in range(n)]) for b in range(bp.n_buckets)]
    if not compressed:
        resids = None
        if live is None:
            means = [torch.mean(sb, dim=0) for sb in buckets]
        else:
            # jnp.mean's bits: the masked peers added in order, times the
            # float32 1/n, then the live renormalization
            scale = sc._live_scale(live, n)
            means = []
            for sb in buckets:
                masked = sb * live[:, None]
                acc = masked[0]
                for row in masked[1:]:
                    acc = acc + row
                means.append(acc * (1.0 / n) * scale)
    elif ts.sync == "faithful":
        means, resids = bucketed_faithful_ring_mean(cfg, buckets, key, bits, stats, aux, live)
    elif ts.sync == "two_phase" or len(dp_sizes) == 1:
        means, resids = bucketed_two_phase_mean(cfg, buckets, key, bits, stats, aux, live)
    else:
        means, resids = bucketed_hierarchical_mean(cfg, buckets, n_pod, key, bits, stats, aux,
                                                   live)
    cm = None
    if ts.metrics_compression:
        rows = []
        for j in range(n):
            sums, static = obs_metrics.local_sums(
                cfgs, per_peer[j], stats[j] if stats is not None else None,
                None if resids is None else [r[j] for r in resids],
                None if ef is None else [e[j] for e in ef], compressed)
            rows.append(obs_metrics.finalize(sums, static, 1))
        cm = obs_metrics.CompressionMetrics(*(torch.stack(fs) for fs in zip(*rows)))
    if not ts.error_feedback:
        resids = None
    return compressors.bucket_split(means, bp, shapes), resids, new_t, cm


def reference_sync(ts, stacked_leaves: list, dp_sizes: tuple, key: torch.Tensor,
                   live=None) -> list:
    """Synced gradient mean as every peer of the mesh computes it.

    ``bucket_mb > 0``: the mean leaves of :func:`reference_sync_state`.
    ``bucket_mb <= 0``: the per-leaf codec, leaf i synced on its own under
    ``fold_in(key, i)``: the plain mean for ``dsgd``, else the sync mode's
    per-tensor mean (two_phase also on a one-axis layout; hierarchical as
    two-phase inside each pod of ``dp_sizes[-1]`` peers, keyed by
    ``fold_in(k1, j)`` for peer j, then faithful across pods under k2).
    The per-leaf path has no live mask: ``live`` raises ``ValueError``.
    """
    cfg = ts.compressor
    if ts.bucket_mb > 0:
        return reference_sync_state(ts, stacked_leaves, dp_sizes, key, live=live)[0]
    if live is not None:
        raise ValueError("elastic live masks require the bucketed codec (bucket_mb > 0); "
                         "the per-leaf path has no live-set semantics")
    n = 1
    for s in dp_sizes:
        n *= s
    n_pod = n // dp_sizes[-1]
    out = []
    for i, x in enumerate(stacked_leaves):
        ki = prng.fold_in(key, i)
        flat = x.reshape(n, -1).to(torch.float32)
        if ts.sync == "dsgd" or cfg.method == "dsgd":
            # jnp.mean's bits: the peer sum times the float32 1/n
            mean = torch.sum(flat, dim=0) * (1.0 / n)
        elif ts.sync == "faithful":
            mean = faithful_ring_mean(cfg, flat, ki)
        elif ts.sync == "two_phase" or len(dp_sizes) == 1:
            mean = two_phase_mean(cfg, flat, ki)
        else:
            mean = hierarchical_mean(cfg, flat, n_pod, ki)
        out.append(mean.reshape(x.shape[1:]))
    return out
