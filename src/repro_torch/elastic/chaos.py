"""Fault-injection harness: scripted dropout traces for elastic sync — the
port of ``repro.elastic.chaos``.

A :class:`ChaosTrace` is a static ``(T, n_peers)`` 0/1 table — row ``t %
T`` is step ``t``'s live mask — fed to the sync through
:class:`repro_torch.elastic.schedule.ElasticConfig(trace=...)`.  Scenario
constructors cover the failure shapes the recovery tests replay:

- :func:`flap` — one peer flip-flops with a fixed period;
- :func:`partition` — a contiguous block of peers goes dark for a window,
  then rejoins (stale-EF recovery);
- :func:`solo_survivor` — every peer but one is down (the k=1 degenerate
  case of every sync mode).

The JSON file format, the JAX package's (each package loads the other's
files)::

    {"version": 1, "name": "...", "n_peers": 4, "rows": [[1,1,0,1], ...]}
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from .schedule import ElasticConfig

TRACE_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ChaosTrace:
    """A scripted dropout table; ``rows[t % T][p]`` is peer p's liveness."""

    rows: tuple[tuple[int, ...], ...]
    name: str = "chaos"

    def __post_init__(self):
        rows = tuple(tuple(int(v) for v in row) for row in self.rows)
        if not rows or not rows[0]:
            raise ValueError("chaos trace needs at least one row and one peer")
        width = len(rows[0])
        for r, row in enumerate(rows):
            if len(row) != width:
                raise ValueError(f"row {r} has {len(row)} peers, row 0 has {width}")
            if any(v not in (0, 1) for v in row):
                raise ValueError(f"row {r} must contain only 0/1 entries")
        object.__setattr__(self, "rows", rows)

    @property
    def n_peers(self) -> int:
        return len(self.rows[0])

    @property
    def n_steps(self) -> int:
        return len(self.rows)

    def elastic(self, min_live: int = 1) -> ElasticConfig:
        """The :class:`ElasticConfig` replaying this trace."""
        return ElasticConfig(trace=self.rows, min_live=min_live)


def flap(n: int, peer: int = 0, period: int = 2, steps: int | None = None) -> ChaosTrace:
    """``peer`` alternates down/up every ``period`` steps, everyone else live."""
    if not (0 <= peer < n):
        raise ValueError(f"peer {peer} out of range for {n} peers")
    if period < 1:
        raise ValueError("period must be >= 1")
    T = steps if steps is not None else 2 * period
    rows = []
    for t in range(T):
        row = [1] * n
        if (t // period) % 2 == 0:
            row[peer] = 0
        rows.append(tuple(row))
    return ChaosTrace(tuple(rows), name=f"flap_p{peer}_per{period}")


def partition(n: int, down: tuple[int, ...] | int, down_steps: int,
              up_steps: int = 1) -> ChaosTrace:
    """Peers in ``down`` (a tuple, or the first ``down`` peers) go dark for
    ``down_steps`` steps, then the whole fleet runs for ``up_steps`` — the
    rejoin window stale-EF recovery is measured over."""
    dead = tuple(range(down)) if isinstance(down, int) else tuple(down)
    if not dead or any(not (0 <= p < n) for p in dead):
        raise ValueError(f"partition peers {dead} out of range for {n} peers")
    if len(dead) >= n:
        raise ValueError("partition cannot take down every peer")
    if down_steps < 1 or up_steps < 1:
        raise ValueError("down_steps and up_steps must be >= 1")
    dark = tuple(0 if p in dead else 1 for p in range(n))
    full = (1,) * n
    return ChaosTrace((dark,) * down_steps + (full,) * up_steps,
                      name=f"partition_{len(dead)}of{n}")


def solo_survivor(n: int, survivor: int = 0, steps: int = 1) -> ChaosTrace:
    """Every peer but ``survivor`` is down: the k=1 degenerate live set."""
    if not (0 <= survivor < n):
        raise ValueError(f"survivor {survivor} out of range for {n} peers")
    row = tuple(1 if p == survivor else 0 for p in range(n))
    return ChaosTrace((row,) * max(steps, 1), name=f"solo_{survivor}of{n}")


def save_trace(trace: ChaosTrace, path) -> None:
    """Write ``trace`` as the versioned JSON trace file."""
    doc = {"version": TRACE_FORMAT_VERSION, "name": trace.name,
           "n_peers": trace.n_peers, "rows": [list(r) for r in trace.rows]}
    pathlib.Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def load_trace(path) -> ChaosTrace:
    """Load a JSON trace file (validates shape and version)."""
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("version") != TRACE_FORMAT_VERSION:
        raise ValueError(
            f"chaos trace {path}: version {doc.get('version')!r}, "
            f"expected {TRACE_FORMAT_VERSION}")
    rows = tuple(tuple(int(v) for v in row) for row in doc["rows"])
    trace = ChaosTrace(rows, name=str(doc.get("name", "chaos")))
    if "n_peers" in doc and int(doc["n_peers"]) != trace.n_peers:
        raise ValueError(
            f"chaos trace {path}: n_peers={doc['n_peers']} does not match "
            f"row width {trace.n_peers}")
    return trace
