"""Phase span recorder: host clock + ``torch.profiler`` labels — the port
of ``repro.obs.trace``.

Two complementary mechanisms cover the step's phases:

- **Host spans** (:class:`SpanRecorder.span`) wrap host-visible phases —
  the train step, the ``AdaptiveStepper`` replan — with the host clock
  (``time.perf_counter``) *and* a
  ``torch.profiler.record_function("repro.obs/<name>")`` label, the JAX
  package's names, so one profiler trace reads the same in both packages.
  Given a CUDA ``device`` the recorder synchronizes it before each clock
  read, at entry and at exit: a span is then the card's time for the work
  issued inside it, not the time to issue it.  Each closed span is
  aggregated in-process and (when a sink is attached) written as a
  ``"span"`` JSONL event.
- **In-step labels** — the encode / collective / decode bodies in
  ``dist.sharded_codec`` and the optimizer update in ``dist.train_step``
  run under ``record_function("obs.encode" | "obs.collective" |
  "obs.decode" | "obs.optimizer")``: regions of a profiler trace, not
  events.

Note for span consumers: the first occurrence of a span typically includes
warm-up (allocator growth, the kernels' first launches);
:meth:`SpanRecorder.summary` reports ``max_s`` alongside the mean so such
spikes stay visible.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

from .sink import SCHEMA_VERSION


def span_event(name: str, t_start: float, dur_s: float, step=None,
               attrs: dict | None = None) -> dict:
    ev = {"v": SCHEMA_VERSION, "kind": "span", "name": str(name),
          "t_start": float(t_start), "dur_s": float(dur_s)}
    if step is not None:
        ev["step"] = int(step)
    if attrs:
        ev["attrs"] = dict(attrs)
    return ev


class SpanRecorder:
    """Records named spans; optionally streams them to a sink.  ``device``:
    a CUDA device to synchronize before each clock read (None or a CPU
    device: never synchronize)."""

    def __init__(self, sink=None, clock=time.perf_counter, device=None):
        self._sink = sink
        self._clock = clock
        dev = None if device is None else torch.device(device)
        self._cuda = dev if dev is not None and dev.type == "cuda" else None
        # name -> [count, total_s, max_s]
        self._agg: dict[str, list[float]] = {}

    def _now(self) -> float:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)
        return self._clock()

    @contextlib.contextmanager
    def span(self, name: str, step=None, **attrs):
        t0 = self._now()
        with record_function(f"repro.obs/{name}"):
            yield
        dur = self._now() - t0
        agg = self._agg.setdefault(name, [0, 0.0, 0.0])
        agg[0] += 1
        agg[1] += dur
        agg[2] = max(agg[2], dur)
        if self._sink is not None:
            self._sink.write(span_event(name, t0, dur, step, attrs))

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-span aggregate: ``{name: {count, total_s, mean_s, max_s}}``."""
        return {
            name: {"count": int(c), "total_s": tot, "mean_s": tot / c, "max_s": mx}
            for name, (c, tot, mx) in sorted(self._agg.items())
        }
