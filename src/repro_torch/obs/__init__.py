"""Compression observability — the port of ``repro.obs``.

The sync of ``dist.train_step`` optionally self-reports a
:class:`~repro_torch.obs.metrics.CompressionMetrics` per bucket
(``TrainStepConfig.metrics_compression``); this package holds that metric
computation plus everything host-side: the JSONL event sinks
(:mod:`repro_torch.obs.sink`, the JAX package's schema), the span recorder
(:mod:`repro_torch.obs.trace`: host clock, synchronized on a card, and
``torch.profiler`` labels), the power-law drift monitor
(:mod:`repro_torch.obs.drift`) and the ``python -m repro_torch.obs report``
CLI (:mod:`repro_torch.obs.report`).

Nothing in this package may import from :mod:`repro_torch.dist`, which
imports it.
"""
from .drift import DriftEvent, DriftMonitor, ObsDriftWarning
from .metrics import CompressionMetrics, MetricStatic, finalize, local_sums
from .sink import (
    METRIC_FIELDS,
    SCHEMA_VERSION,
    EmaAggregator,
    JsonlSink,
    export_csv,
    metrics_event,
    read_events,
)
from .trace import SpanRecorder, span_event

__all__ = [
    "METRIC_FIELDS",
    "SCHEMA_VERSION",
    "CompressionMetrics",
    "DriftEvent",
    "DriftMonitor",
    "EmaAggregator",
    "JsonlSink",
    "MetricStatic",
    "ObsDriftWarning",
    "SpanRecorder",
    "export_csv",
    "finalize",
    "local_sums",
    "metrics_event",
    "read_events",
    "span_event",
]
