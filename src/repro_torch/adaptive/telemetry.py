"""Streaming per-bucket gradient statistics for the adaptive controller —
the port of ``repro.adaptive.telemetry``.

``TelemetryState`` holds, per bucket, an EMA of the one-pass statistics
(the 128-bin log2-spaced |g| histogram, the per-bin sums of ln|g|, a
decayed max envelope, the first and second moments).  The sync keeps one
stacked row per peer and folds in the statistics it already computed for
the plan (K1 with error feedback, else K10), with no extra pass;
:func:`aggregate_peers` merges the rows for the controller.  γ, ρ and the
quantile are ratios of co-scaled accumulators, so the EMA needs no
debiasing.  :func:`estimate_tails` and :func:`estimate_densities` fit the
tail and the density of each bucket from the EMA histogram, with
``g_min`` snapped to a bin edge (``core.distributions.tail_from_histogram``).
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import torch

from repro_torch.core.distributions import (EmpiricalDensity, PowerLawTail,
                                            density_from_histogram, tail_from_histogram)
from repro_torch.kernels import ops
from repro_torch.kernels import stats as kstats

NUM_BINS = kstats.NUM_BINS


class TelemetryState(NamedTuple):
    """Per-bucket streaming statistics, stacked over buckets (leading axis
    B); the sync stacks one more leading axis per peer."""

    counts: torch.Tensor    # (B, NUM_BINS) EMA histogram counts of |g|
    log_sums: torch.Tensor  # (B, NUM_BINS) EMA per-bin sums of ln|g|
    g_max: torch.Tensor     # (B,) decayed max-|g| envelope
    mean: torch.Tensor      # (B,) EMA of the bucket mean
    msq: torch.Tensor       # (B,) EMA of the bucket second moment
    steps: torch.Tensor     # () number of updates folded in


def init_telemetry(n_buckets: int, device=None) -> TelemetryState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return TelemetryState(counts=zeros(n_buckets, NUM_BINS), log_sums=zeros(n_buckets, NUM_BINS),
                          g_max=zeros(n_buckets), mean=zeros(n_buckets), msq=zeros(n_buckets),
                          steps=zeros())


def peer_row(state: TelemetryState, j: int) -> TelemetryState:
    """Row j of a per-peer stacked state."""
    return TelemetryState(*(f[j] for f in state))


def stack_rows(rows: Sequence[TelemetryState]) -> TelemetryState:
    """Per-peer rows stacked along a new leading axis."""
    return TelemetryState(*(torch.stack(fs) for fs in zip(*rows)))


def bucket_statistics(g: torch.Tensor):
    """(counts, log_sums, g_max, g_sum, g_sumsq) of one flat bucket (K10)."""
    return tuple(ops.bucket_stats(g))


def correct_stats(g: torch.Tensor, e: torch.Tensor | None = None):
    """One-pass EF correction + statistics of one flat gradient bucket.

    Returns ``(corrected, (counts, log_sums, g_max, g_sum, g_sumsq))`` with
    ``corrected = g + e`` (K1), or ``g`` itself and its statistics (K10)
    when ``e`` is None.
    """
    if e is None:
        return g, bucket_statistics(g)
    c, s = ops.ef_correct_stats(g, e)
    return c, tuple(s)


def update_telemetry(state: TelemetryState, buckets: Sequence[torch.Tensor], *,
                     decay: float = 0.9, stats: Sequence | None = None) -> TelemetryState:
    """Fold one step's buckets into the EMA state (B must match).

    ``stats`` (one :func:`correct_stats`-shaped tuple per bucket) are the
    statistics the sync already computed; without them each bucket gets
    its own pass (K10).
    """
    if len(buckets) != state.counts.shape[0]:
        raise ValueError(f"telemetry state has {state.counts.shape[0]} buckets, "
                         f"got {len(buckets)}")
    d = torch.tensor(decay, dtype=torch.float32, device=state.counts.device)
    keep = 1.0 - d
    counts, log_sums, gmaxs, means, msqs = [], [], [], [], []
    for b, g in enumerate(buckets):
        c, ls, gm, gs, gq = stats[b] if stats is not None else bucket_statistics(g)
        n = torch.tensor(float(max(g.numel(), 1)), dtype=torch.float32, device=d.device)
        counts.append(d * state.counts[b] + keep * c)
        log_sums.append(d * state.log_sums[b] + keep * ls)
        gmaxs.append(torch.maximum(gm, d * state.g_max[b]))
        means.append(d * state.mean[b] + keep * gs / n)
        msqs.append(d * state.msq[b] + keep * gq / n)
    return TelemetryState(counts=torch.stack(counts), log_sums=torch.stack(log_sums),
                          g_max=torch.stack(gmaxs), mean=torch.stack(means),
                          msq=torch.stack(msqs), steps=state.steps + 1.0)


def aggregate_peers(state: TelemetryState) -> TelemetryState:
    """Merge the per-peer stacked rows (leading axis) into one state: the
    counts and ln sums add, the max envelopes join, the moments average
    (the sum times the float32 1/peers, ``jnp.mean``'s bits)."""
    inv = 1.0 / state.mean.shape[0]
    return TelemetryState(counts=torch.sum(state.counts, dim=0),
                          log_sums=torch.sum(state.log_sums, dim=0),
                          g_max=torch.amax(state.g_max, dim=0),
                          mean=torch.sum(state.mean, dim=0) * inv,
                          msq=torch.sum(state.msq, dim=0) * inv,
                          steps=torch.amax(state.steps, dim=0))


def estimate_densities(state: TelemetryState) -> list[EmpiricalDensity]:
    """Per-bucket piecewise-constant |g| densities from the EMA histogram,
    on the statistics' log2-spaced edges (the ``EmpiricalDensity`` the
    non-uniform α solvers and the Q_N error model take)."""
    edges = kstats.bin_edges(state.counts.device)
    return [density_from_histogram(state.counts[b], edges)
            for b in range(state.counts.shape[0])]


def estimate_tails(state: TelemetryState, *, gmin_quantile: float = 0.9) -> PowerLawTail:
    """Histogram-based power-law tail fit per bucket, each field stacked
    (B,): ``g_min`` the upper edge of the bin where the |g| CDF crosses
    ``gmin_quantile``, γ the Hill estimator over the bins above it."""
    edges = kstats.bin_edges(state.counts.device)
    rows = [tail_from_histogram(c, ls, gm, edges, gmin_quantile=gmin_quantile)
            for c, ls, gm in zip(state.counts, state.log_sums, state.g_max)]
    return PowerLawTail(*(torch.stack(fs) for fs in zip(*rows)))
