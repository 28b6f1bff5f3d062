"""Compression observability — the port of ``repro.obs``, so far its
per-bucket metrics (:mod:`repro_torch.obs.metrics`), which
``dist.reference.reference_sync_state`` returns under
``TrainStepConfig.metrics_compression``.

Nothing in this package may import from :mod:`repro_torch.dist`, which
imports it.
"""
from .metrics import CompressionMetrics, MetricStatic, finalize, local_sums

__all__ = ["CompressionMetrics", "MetricStatic", "finalize", "local_sums"]
