"""Report tables for the launcher — the port of ``repro.launch.report``'s
``adaptive_table``.  Its dry-run and roofline tables render the JAX
package's XLA dry-run records and come with the port of the dry run
(ROADMAP Queue 1, ``launch/``)."""
from __future__ import annotations


def adaptive_table(sizes, bits, alphas=None, gammas=None, rhos=None) -> str:
    """Markdown table of one adaptive bit plan: per-bucket elements, wire
    bits, solver α and (when known) the telemetry-estimated tail (γ, ρ).
    Used by ``launch.train --adaptive``."""
    n = len(sizes)
    alphas = list(alphas) if alphas else [None] * n
    gammas = list(gammas) if gammas is not None else [None] * n
    rhos = list(rhos) if rhos is not None else [None] * n
    rows = ["| bucket | elements | bits | alpha | gamma | rho |",
            "|---|---|---|---|---|---|"]

    def fmt(v, spec):
        return format(float(v), spec) if v is not None else "-"

    for b in range(n):
        rows.append(
            f"| {b} | {sizes[b]} | {bits[b]} | {fmt(alphas[b], '.3e')} "
            f"| {fmt(gammas[b], '.2f')} | {fmt(rhos[b], '.3f')} |")
    return "\n".join(rows)
