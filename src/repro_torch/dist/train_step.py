"""Per-step gradient-sync configuration — the fields of
``repro.dist.train_step.TrainStepConfig`` that the reference sync reads,
with the JAX package's checks.  ``streamed`` and ``metrics_gnorm`` come
with the mesh train step (ROADMAP Queue 1)."""
from __future__ import annotations

import dataclasses

from repro_torch.adaptive.controller import AdaptiveConfig
from repro_torch.core.compressors import CompressorConfig
from repro_torch.elastic.schedule import ElasticConfig

SYNC_MODES = ("dsgd", "two_phase", "hierarchical", "faithful")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """``bucket_mb > 0`` coalesces the gradient leaves into ~``bucket_mb``-MB
    fp32 buckets with one codebook each; ``error_feedback`` carries a
    bucket-resident (n_clients, bucket_elems) EF residual from step to
    step; ``adaptive`` keeps a per-client telemetry state the same way
    (``dist.reference.reference_sync_state(tstate=...)``, decay
    ``adaptive.ema``); ``bits_plan`` gives each bucket its own width;
    buckets of at most ``fp16_threshold`` elements ship raw fp16 (0 =
    off); ``metrics_compression`` makes the sync return every peer's
    ``obs.metrics.CompressionMetrics``; ``elastic`` is the deterministic
    partial-participation schedule whose per-step live mask
    (``elastic.live_mask``) the sync renormalizes the peer mean over,
    dropped peers' EF rows accumulating.  ``bucket_mb=0`` selects the
    per-leaf codec, which takes none of these."""

    sync: str = "dsgd"
    compressor: CompressorConfig = dataclasses.field(default_factory=CompressorConfig)
    bucket_mb: float = 4.0
    error_feedback: bool = False
    adaptive: AdaptiveConfig | None = None
    bits_plan: tuple[int, ...] | None = None
    metrics_compression: bool = False
    elastic: ElasticConfig | None = None
    fp16_threshold: int = 0

    def __post_init__(self):
        if self.sync not in SYNC_MODES:
            raise ValueError(f"unknown sync mode {self.sync!r}; expected one of {SYNC_MODES}")
        if self.bucket_mb < 0:
            raise ValueError("bucket_mb must be >= 0 (0 selects the per-leaf codec)")
        if self.error_feedback:
            if self.sync == "dsgd" or self.compressor.method == "dsgd":
                raise ValueError("error_feedback requires a compressed sync mode/method")
            if self.bucket_mb <= 0:
                raise ValueError("error_feedback requires the bucketed codec (bucket_mb > 0)")
        if self.adaptive is not None:
            if self.sync == "dsgd" or self.compressor.method == "dsgd":
                raise ValueError("adaptive telemetry requires a compressed sync mode/method")
            if self.bucket_mb <= 0:
                raise ValueError("adaptive telemetry requires the bucketed codec (bucket_mb > 0)")
        if self.metrics_compression and self.bucket_mb <= 0:
            raise ValueError("metrics_compression requires the bucketed codec (bucket_mb > 0)")
        if self.elastic is not None and self.bucket_mb <= 0:
            raise ValueError("elastic sync requires the bucketed codec (bucket_mb > 0)")
        if self.fp16_threshold < 0:
            raise ValueError("fp16_threshold must be >= 0 (0 disables the tier)")
        if self.fp16_threshold > 0 and self.bucket_mb <= 0:
            raise ValueError("fp16_threshold targets the bucketed codec (bucket_mb > 0)")
        if self.bits_plan is not None:
            if self.bucket_mb <= 0:
                raise ValueError("bits_plan targets the bucketed codec (bucket_mb > 0)")
            norm = []
            for b in self.bits_plan:
                if isinstance(b, tuple | list):
                    from repro_torch.core.codecs import bucket_cfg_entry

                    bucket_cfg_entry(self.compressor, b)
                    norm.append((str(b[0]), int(b[1])))
                else:
                    if not (1 <= int(b) <= 8):
                        raise ValueError("bits_plan entries must be in [1, 8]")
                    norm.append(int(b))
            object.__setattr__(self, "bits_plan", tuple(norm))

    @property
    def bucket_elements(self) -> int:
        return int(self.bucket_mb * (1 << 20) / 4)
