"""Elastic partial participation: deterministic peer dropout — the port of
``repro.elastic``.

This package says who is live at a step; the sync
(``dist.reference`` with ``dist.sharded_codec``'s live helpers) says what
a live mask means: a dropped peer's wire is zeroed, the mean is
renormalized over the live count, and the dropped peer's EF row keeps its
whole corrected bucket.

- :mod:`repro_torch.elastic.schedule` — :class:`ElasticConfig` and the
  counter-hash :func:`live_mask`, a pure function of ``(seed, step,
  peer_id)``, bit for bit the JAX package's;
- :mod:`repro_torch.elastic.chaos` — scripted :class:`ChaosTrace`
  dropout tables (flap, partition, solo survivor) in the JAX package's
  versioned JSON format.
"""
from .chaos import ChaosTrace, flap, load_trace, partition, save_trace, solo_survivor
from .schedule import ElasticConfig, expected_live_fraction, live_mask

__all__ = [
    "ChaosTrace",
    "ElasticConfig",
    "expected_live_fraction",
    "flap",
    "live_mask",
    "load_trace",
    "partition",
    "save_trace",
    "solo_survivor",
]
