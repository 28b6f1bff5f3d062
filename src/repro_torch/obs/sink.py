"""Event sinks for the observability layer: JSONL writer, reader, EMA, CSV —
the port of ``repro.obs.sink``, whose JSONL schema it keeps: the JAX
package's reader reads the port's logs and the reverse.

Every event is one JSON object per line with a mandatory ``"v"`` schema
version (:data:`SCHEMA_VERSION`) and a ``"kind"`` discriminator:

- ``{"v": 1, "kind": "metrics", "step": i, "buckets": [{"bucket": b,
  "bits": ..., "rank": ..., "alpha": ..., "clip_frac": ..., "ef_norm": ...,
  "wire_bytes": ..., "realized_mse": ..., "predicted_mse": ...}, ...]}`` —
  one per logged step, peer-averaged from the train step's
  :class:`repro_torch.obs.metrics.CompressionMetrics`;
- ``{"v": 1, "kind": "span", "name": ..., "t_start": ..., "dur_s": ...,
  "step": ..., "attrs": {...}}`` — phase spans (:mod:`repro_torch.obs.trace`);
- ``{"v": 1, "kind": "drift", ...}`` — structured drift warnings
  (:mod:`repro_torch.obs.drift`);
- ``{"v": 1, "kind": "dropout", "step": i, "live": ..., "n_peers": ...,
  "dropped": [...]}`` — the launcher's elastic steps with a peer down.

``python -m repro_torch.obs report`` consumes a directory of these files.
"""
from __future__ import annotations

import csv
import json
import pathlib
import sys

import numpy as np
import torch

SCHEMA_VERSION = 1

#: flat per-bucket fields of a "metrics" event, in column order
METRIC_FIELDS = ("bits", "rank", "alpha", "clip_frac", "ef_norm",
                 "wire_bytes", "realized_mse", "predicted_mse")


class JsonlSink:
    """Append-only JSONL event writer with buffered flushing.

    ``flush_every`` bounds the number of buffered events before an fsync-free
    flush; the sink is also a context manager (flushes on exit).  The parent
    directory is created on first write, so ``runs/obs/<name>.jsonl`` works
    without setup.
    """

    def __init__(self, path, flush_every: int = 16):
        self.path = pathlib.Path(path)
        self.flush_every = max(1, int(flush_every))
        self._buf: list[str] = []
        self._fh = None
        self.n_written = 0

    def write(self, event: dict) -> None:
        event.setdefault("v", SCHEMA_VERSION)
        self._buf.append(json.dumps(event, sort_keys=True))
        self.n_written += 1
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        self._fh.write("\n".join(self._buf) + "\n")
        self._fh.flush()
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_events(path) -> list[dict]:
    """Load events from one ``.jsonl`` file or every ``*.jsonl`` in a
    directory.  Malformed lines and version-mismatched events are skipped
    with a one-line warning naming the offending path (never silently)."""
    p = pathlib.Path(path)
    if not p.exists():
        print(f"warning: no event log at {p}", file=sys.stderr)
        return []
    files = sorted(p.glob("*.jsonl")) if p.is_dir() else [p]
    events = []
    for f in files:
        for ln, line in enumerate(f.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                print(f"warning: skipping malformed event {f}:{ln}: {e}",
                      file=sys.stderr)
                continue
            if not isinstance(ev, dict) or ev.get("v") != SCHEMA_VERSION:
                print(f"warning: skipping event with unknown schema {f}:{ln} "
                      f"(v={ev.get('v') if isinstance(ev, dict) else None!r})",
                      file=sys.stderr)
                continue
            events.append(ev)
    return events


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a number) as a numpy array
    on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def metrics_event(step: int, comp) -> dict:
    """Host-side conversion of a :class:`CompressionMetrics` (leaves
    ``(n_dp, B)`` as returned by the train step, or ``(B,)``, on any
    device) into one peer-averaged ``"metrics"`` event: the JAX package's
    numpy arithmetic on the same values, so the same JSON line."""
    arrs = {k: np.atleast_2d(host_array(v)) for k, v in zip(comp._fields, comp)}
    n_buckets = arrs["bits"].shape[-1]
    buckets = []
    for b in range(n_buckets):
        row = {"bucket": b}
        for k in METRIC_FIELDS:
            col = arrs[k][:, b]
            row[k] = int(col[0]) if k in ("bits", "rank") else float(np.mean(col))
        buckets.append(row)
    return {"v": SCHEMA_VERSION, "kind": "metrics", "step": int(step),
            "buckets": buckets}


class EmaAggregator:
    """Exponential moving average over the per-bucket metric fields.

    ``update`` folds one ``"metrics"`` event; ``summary()`` returns the
    smoothed per-bucket rows (same field names as the events).  The first
    observation seeds the EMA.
    """

    def __init__(self, decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError("decay must be in [0, 1)")
        self.decay = decay
        self.state: dict[int, dict[str, float]] = {}
        self.n_events = 0

    def update(self, event: dict) -> None:
        if event.get("kind") != "metrics":
            return
        self.n_events += 1
        for row in event.get("buckets", []):
            b = int(row["bucket"])
            cur = self.state.setdefault(b, {})
            for k in METRIC_FIELDS:
                if k not in row:
                    continue
                v = float(row[k])
                cur[k] = v if k not in cur else self.decay * cur[k] + (1.0 - self.decay) * v

    def summary(self) -> list[dict]:
        return [{"bucket": b, **vals} for b, vals in sorted(self.state.items())]


def export_csv(events: list[dict], path) -> int:
    """Write every ``"metrics"`` event as flat CSV rows
    (``step,bucket,<METRIC_FIELDS...>``); returns the row count."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with p.open("w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(("step", "bucket") + METRIC_FIELDS)
        for ev in events:
            if ev.get("kind") != "metrics":
                continue
            for row in ev.get("buckets", []):
                w.writerow([ev.get("step"), row.get("bucket")]
                           + [row.get(k) for k in METRIC_FIELDS])
                n += 1
    return n
