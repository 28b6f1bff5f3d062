"""Static-analysis passes over the port (``python -m repro_torch.analysis``)
— the port of ``repro.analysis``.

Three passes, one rule-code band each:

- ``REPRO1xx`` — :mod:`repro_torch.analysis.sync_lint`: runs every sync mode
  × codec through ``dist.train_step.make_sync_fn`` on a gloo group of four
  ranks (and the one-process ``dist.reference`` replay), with a spy on
  ``dist.compat``'s collectives and the PRNG's draws and a
  ``TorchDispatchMode`` over every op: collective counts against the codec
  registry's budgets, per-rank draws (ranks given equal gradients must draw
  different uniforms), float64 values, float scatter-adds whose order is
  free, and non-int32 wires crossing a compressed collective.
- ``REPRO2xx`` — :mod:`repro_torch.analysis.ast_lint`: the port's
  architectural rules over its source tree — no method-string dispatch in
  the collective bodies, no kernel library loaded or launched outside
  ``kernels/``, every public wrapper of ``kernels/ops.py`` dispatching
  through ``_on_card`` with no fallback that hides a failed kernel, no
  literal seeds in library code.
- ``REPRO3xx`` — :mod:`repro_torch.analysis.kernel_resources`: each CUDA
  kernel's registers, shared memory, stack and spills from the ``-Xptxas
  -v`` reports of the build, against the card's limits.

A finding is suppressed by a source comment on (or one line above) the
offending line::

    hist.index_add(0, slot, v)  # repro: allow REPRO104 (CPU-only path)

This module is import-light (no torch): the AST pass runs anywhere.
"""
from __future__ import annotations

import dataclasses
import re

__all__ = ["Finding", "RULES", "suppressed_codes", "filter_suppressed"]

#: rule code -> one-line description (the taxonomy REPRO1xx/2xx/3xx)
RULES = {
    "REPRO101": "collective count exceeds the mode's declared budget",
    "REPRO102": "a draw in the sync whose key does not depend on the rank "
                "(ranks with equal gradients draw equal quantization noise)",
    "REPRO103": "float64 value in the sync",
    "REPRO104": "nondeterministic float reduction (a float index_add_, "
                "scatter_add_ or index_put_(accumulate=True))",
    "REPRO105": "non-int32 tensor crossing a compressed-wire collective",
    "REPRO201": "method-string dispatch inside a collective body",
    "REPRO202": "kernel library loaded or launched outside kernels/",
    "REPRO203": "kernel wrapper without _on_card dispatch, or with a fallback "
                "that hides a failed build or launch",
    "REPRO204": "literal seed in library code",
    "REPRO301": "CUDA kernel spills, or exceeds its shared-memory or register budget",
}

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\s+(REPRO\d{3}(?:\s*,\s*REPRO\d{3})*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source location when known."""

    code: str            # REPROxxx
    where: str           # "path:line" or a run label like "sync:faithful/tqsgd"
    message: str

    def __str__(self) -> str:
        return f"{self.where}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return {"code": self.code, "where": self.where, "message": self.message}


def suppressed_codes(source_lines: list[str], lineno: int) -> frozenset[str]:
    """Codes allowed at 1-based ``lineno``: a ``# repro: allow REPROxxx``
    comment on the line itself or on the line directly above."""
    codes: set[str] = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            m = _ALLOW_RE.search(source_lines[ln - 1])
            if m:
                codes.update(c.strip() for c in m.group(1).split(","))
    return frozenset(codes)


def filter_suppressed(findings: list[Finding], sources: dict[str, list[str]]) -> list[Finding]:
    """Drop findings whose ``path:line`` location carries an allow comment.

    ``sources`` maps path -> source lines; findings anchored to unlisted
    paths (or to run labels) pass through unfiltered.
    """
    out = []
    for f in findings:
        path, _, line = f.where.rpartition(":")
        if (path in sources and line.isdigit()
                and f.code in suppressed_codes(sources[path], int(line))):
            continue
        out.append(f)
    return out
