"""Drift monitor: structured warnings when the paper's error model breaks —
the port of ``repro.obs.drift``, its events and messages word for word.

The controller's α/bit allocation assumes the per-bucket gradient magnitude
follows a power-law tail with index γ ∈ (3, 5] (paper §3; the Hill estimate
in ``core.distributions.tail_from_histogram`` is *clipped* to
``[GAMMA_MIN, GAMMA_MAX]``).  Three drift signals are watched:

- **tail regime** (:meth:`DriftMonitor.check_tails`): a bucket's estimated
  γ sitting on a clip rail means the raw Hill estimate left the power-law
  regime the controller assumed — the fit railed, it did not converge.
- **error ratio** (:meth:`DriftMonitor.check_ratio`): realized quantization
  MSE exceeding the predicted E_TQ by more than ``ratio_threshold`` — the
  fitted tail no longer describes the data the codec is quantizing.
- **participation** (:meth:`DriftMonitor.check_participation`): the elastic
  live fraction falling below ``participation_floor`` — the surviving
  peers' renormalized mean is being computed from too small a sample for
  the per-bucket statistics the controller fitted to stay representative.

Each violation produces a :class:`DriftEvent` (kept on the monitor,
optionally written to a JSONL sink as a ``"drift"`` event) and a Python
:class:`ObsDriftWarning` via ``warnings.warn`` so library users can route
or silence them with the stdlib machinery.  Inputs may be tensors on any
device: they are read on the host in float64.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.distributions import GAMMA_MAX, GAMMA_MIN

from .sink import SCHEMA_VERSION, host_array


class ObsDriftWarning(UserWarning):
    """Category for compression-drift warnings raised by :class:`DriftMonitor`."""


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    kind: str     # "tail_regime" | "error_ratio" | "participation"
    bucket: int   # -1 for mesh-wide events (participation)
    step: int
    value: float  # the offending γ, realized/predicted ratio, or live fraction
    lo: float
    hi: float

    def message(self) -> str:
        if self.kind == "tail_regime":
            return (f"bucket {self.bucket} step {self.step}: Hill tail index "
                    f"gamma={self.value:.3f} railed outside the power-law regime "
                    f"({self.lo:.2f}, {self.hi:.2f}) the controller assumes")
        if self.kind == "participation":
            return (f"step {self.step}: live fraction {self.value:.2f} fell "
                    f"below the participation floor {self.lo:.2f} — the "
                    f"renormalized mean is running on a thin live set")
        return (f"bucket {self.bucket} step {self.step}: realized/predicted "
                f"quantization MSE ratio {self.value:.2f} exceeds {self.hi:.2f} "
                f"— the heavy-tail fit no longer matches the gradients")

    def to_event(self) -> dict:
        return {"v": SCHEMA_VERSION, "kind": "drift", "drift": self.kind,
                "bucket": self.bucket, "step": self.step,
                "value": self.value, "lo": self.lo, "hi": self.hi,
                "message": self.message()}


def _f64(x) -> np.ndarray:
    return np.asarray(host_array(x), dtype=np.float64).reshape(-1)


class DriftMonitor:
    """Consumes telemetry tail estimates and metrics rows; raises on drift.

    ``gamma_margin`` is the rail-detection slack around the estimator's
    ``[GAMMA_MIN, GAMMA_MAX]`` clip range; ``ratio_threshold`` the
    realized/predicted MSE ratio above which a bucket is flagged;
    ``participation_floor`` the elastic live fraction below which a step
    is flagged.  ``warn=False`` suppresses ``warnings.warn`` (events are
    still recorded).
    """

    def __init__(self, sink=None, gamma_margin: float = 0.02,
                 ratio_threshold: float = 4.0,
                 participation_floor: float = 0.5, warn: bool = True):
        self.sink = sink
        self.gamma_lo = GAMMA_MIN + gamma_margin
        self.gamma_hi = GAMMA_MAX - gamma_margin
        self.ratio_threshold = float(ratio_threshold)
        self.participation_floor = float(participation_floor)
        self.warn = warn
        self.events: list[DriftEvent] = []

    def _emit(self, ev: DriftEvent) -> None:
        self.events.append(ev)
        if self.sink is not None:
            self.sink.write(ev.to_event())
        if self.warn:
            warnings.warn(ev.message(), ObsDriftWarning, stacklevel=3)

    def check_tails(self, tails, step: int = 0) -> list[DriftEvent]:
        """``tails``: a stacked :class:`~repro_torch.core.distributions.PowerLawTail`
        (``adaptive.telemetry.estimate_tails`` output) or any array of per-
        bucket γ estimates.  Flags buckets whose γ sits on a clip rail."""
        gammas = _f64(getattr(tails, "gamma", tails))
        new = []
        for b, g in enumerate(gammas):
            if g <= self.gamma_lo or g >= self.gamma_hi:
                ev = DriftEvent("tail_regime", b, int(step), float(g),
                                float(GAMMA_MIN), float(GAMMA_MAX))
                self._emit(ev)
                new.append(ev)
        return new

    def check_ratio(self, realized, predicted, step: int = 0) -> list[DriftEvent]:
        """Flags buckets with ``realized > ratio_threshold * predicted``.
        Buckets without a prediction (``predicted <= 0``: rank-based or
        uncompressed) are skipped — there is no model to drift from."""
        realized = _f64(realized)
        predicted = _f64(predicted)
        new = []
        for b, (r, p) in enumerate(zip(realized, predicted)):
            if p <= 0.0 or not np.isfinite(p) or not np.isfinite(r):
                continue
            ratio = r / p
            if ratio > self.ratio_threshold:
                ev = DriftEvent("error_ratio", b, int(step), float(ratio),
                                0.0, self.ratio_threshold)
                self._emit(ev)
                new.append(ev)
        return new

    def check_participation(self, live_frac, step: int = 0) -> list[DriftEvent]:
        """Flags a step whose elastic live fraction sits below the floor.

        ``live_frac`` is ``live_count / n_peers`` for the step (any scalar
        convertible); ``bucket`` is reported as ``-1`` — participation is a
        mesh-wide property, not a per-bucket one.
        """
        frac = float(_f64(live_frac)[0])
        if not np.isfinite(frac) or frac >= self.participation_floor:
            return []
        ev = DriftEvent("participation", -1, int(step), frac,
                        self.participation_floor, 1.0)
        self._emit(ev)
        return [ev]
