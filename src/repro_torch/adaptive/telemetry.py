"""One-pass per-bucket gradient statistics — the part of
``repro.adaptive.telemetry`` the sync reads.  The EMA telemetry state and
the tail estimators are still to port (ROADMAP Queue 1 item 9)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


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
