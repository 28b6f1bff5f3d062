"""Single-device reference of the bucketed faithful gradient sync.

The port of ``repro.dist.reference``'s faithful path: every peer's bucket
is EF-corrected with its one-pass statistics (``correct_stats``), planned
from those statistics, encoded with the fused encode→pack→residual pass
under the peer's and bucket's folded key, and the stacked wires are decoded
into the peer mean — the all-gather of the mesh sync replaced by stacking
over a peer axis on one device.  On the card every step runs the port's
CUDA kernels; on the CPU their plain versions.

Ported: the faithful mode, with error feedback on and off, and the
uncompressed ``dsgd`` mean.  Still to port: the two-phase and hierarchical
modes and the per-leaf codec (ROADMAP Queue 1 item 8), adaptive telemetry
state (item 9), elastic live masks (item 11) and compression metrics
(item 12).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.adaptive import telemetry
from repro_torch.core import compressors, prng
from repro_torch.core.codecs import bucket_cfgs, get_codec, size_adaptive_plan
from repro_torch.core.compressors import CompressorConfig


def _peer_stats(buckets: list, stats: list | None) -> list:
    """``stats[i][b]``: peer i's one-pass statistics of bucket b."""
    if stats is not None:
        return stats
    n = buckets[0].shape[0]
    return [[telemetry.bucket_statistics(sb[i].to(torch.float32)) for sb in buckets]
            for i in range(n)]


def bucketed_faithful_ring_mean(
    cfg: CompressorConfig, buckets: list, key: torch.Tensor,
    bits: Sequence | None = None, stats: list | None = None,
) -> tuple[list, list]:
    """Faithful ring mean over stacked (n, m_b) buckets.

    Peer i encodes bucket b under ``fold_in(fold_in(key, i), b)`` (the
    per-peer fold only when n > 1).  Returns ``(mean_buckets,
    state_stacked)`` with ``state_stacked[b]`` the (n, m_b) per-peer EF
    residual rows.
    """
    n = buckets[0].shape[0]
    keys = [prng.fold_in(key, i) for i in range(n)] if n > 1 else [key]
    cfgs = bucket_cfgs(cfg, len(buckets), bits)
    codecs = [get_codec(c.method) for c in cfgs]
    stats = _peer_stats(buckets, stats)
    means, states = [], []
    for b, sb in enumerate(buckets):
        wires, rows = [], []
        for i in range(n):
            flat = sb[i].to(torch.float32)
            pln = codecs[b].plan(cfgs[b], flat, stats[i][b])
            w, r = codecs[b].encode_residual(cfgs[b], flat, pln, prng.fold_in(keys[i], b))
            wires.append(w)
            rows.append(r)
        states.append(torch.stack(rows))
        means.append(codecs[b].decode_reduce(cfgs[b], torch.stack(wires), sb.shape[1]))
    return means, states


def reference_sync_state(ts, stacked_leaves: list, dp_sizes: tuple, key: torch.Tensor,
                         ef=None, tstate=None, live=None):
    """Bucketed sync of every peer on one device.

    ``stacked_leaves``: one (n, *leaf_shape) fp32 tensor per gradient leaf,
    in ``jax.tree.leaves`` order; ``dp_sizes``: the data-parallel axis
    sizes (their product is n); ``ef``: a list of stacked (n, m_b)
    bucket-resident residuals, or None.  Returns ``(mean_leaves,
    resid_stacked | None, None, None)``; the last two slots are the JAX
    package's telemetry state and compression metrics.
    """
    if tstate is not None:
        raise NotImplementedError("adaptive telemetry state is not ported yet (ROADMAP Queue 1 item 9)")
    if live is not None:
        raise NotImplementedError("elastic live masks are not ported yet (ROADMAP Queue 1 item 11)")
    if ts.metrics_compression:
        raise NotImplementedError("compression metrics are not ported yet (ROADMAP Queue 1 item 12)")
    cfg = ts.compressor
    n = 1
    for s in dp_sizes:
        n *= s
    shapes = [tuple(x.shape[1:]) for x in stacked_leaves]
    bp = compressors.plan_buckets([x[0].numel() for x in stacked_leaves], ts.bucket_elements)
    per_peer = [compressors.bucket_concat([x[j] for x in stacked_leaves], bp) for j in range(n)]
    compressed = not (ts.sync == "dsgd" or cfg.method == "dsgd")
    bits = size_adaptive_plan(cfg, ts.bits_plan, bp.sizes, ts.fp16_threshold)
    stats = None
    if compressed:
        if ts.sync != "faithful":
            raise NotImplementedError(
                f"sync mode {ts.sync!r} is not ported yet (ROADMAP Queue 1 item 8)")
        stats = []
        for j in range(n):
            row, srow = [], []
            for b, g in enumerate(per_peer[j]):
                c, st = telemetry.correct_stats(g, ef[b][j] if ef is not None else None)
                row.append(c)
                srow.append(st)
            per_peer[j] = row
            stats.append(srow)
    buckets = [torch.stack([per_peer[j][b] for j in range(n)]) for b in range(bp.n_buckets)]
    if not compressed:
        means, resids = [torch.mean(sb, dim=0) for sb in buckets], None
    else:
        means, resids = bucketed_faithful_ring_mean(cfg, buckets, key, bits, stats)
    if not ts.error_feedback:
        resids = None
    return compressors.bucket_split(means, bp, shapes), resids, None, None


def reference_sync(ts, stacked_leaves: list, dp_sizes: tuple, key: torch.Tensor,
                   live=None) -> list:
    """Synced gradient mean as every peer of the mesh computes it (the mean
    leaves of :func:`reference_sync_state`)."""
    if ts.bucket_mb <= 0:
        raise NotImplementedError("the per-leaf codec (bucket_mb=0) is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    return reference_sync_state(ts, stacked_leaves, dp_sizes, key, live=live)[0]
