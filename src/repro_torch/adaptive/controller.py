"""Wire-budget bit allocation across gradient buckets — the port of
``repro.adaptive.controller``.

From one power-law tail per bucket (``telemetry.estimate_tails``) the
allocator water-fills discrete bits per bucket under a global bytes/step
budget: from ``min_bits`` everywhere, the bucket with the best predicted
error reduction per extra wire byte gets one more bit, until nothing fits.
The error of bucket b at k bits is ``size_b · E_TQ(tail_b, α*(k), k)``,
with α* from the ``core.optimal`` fixed-point solver and E_TQ from
``core.theory``: the non-uniform model (Q_N, Eq. 19's α) for the codebook
methods when per-bucket densities are given (``telemetry.
estimate_densities``), the uniform one (Eq. 11/12) otherwise.
:func:`allocate_plan` also offers each bucket a ``("powersgd", rank)``
entry, scored under a power-law singular-value decay.

Plans are host-side Python (tuples of ints and pairs), the same values as
the JAX package's on the same tails: a bucket's bit width is static in
the step that runs it.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import NamedTuple

import torch

from repro_torch.core import optimal, theory
from repro_torch.core.compressors import CompressorConfig, wire_bytes
from repro_torch.core.distributions import EmpiricalDensity, PowerLawTail


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive bucketed-sync configuration (``TrainStepConfig.adaptive``),
    field for field the JAX package's, its runtime's fields included.

    ``wire_budget_mb <= 0`` pins the budget to what the fixed allocation at
    ``compressor.bits`` spends, so the controller only redistributes those
    bytes.  ``ema`` is the telemetry decay; replans wait for
    ``warmup_steps`` updates.  ``switch_threshold`` is the relative
    predicted-error margin a new plan must win by, ``max_cached_steps`` the
    runtime's step cache, ``live_hysteresis`` the relative move of the live
    fraction that re-bases the budget.
    """

    wire_budget_mb: float = 0.0
    replan_every: int = 20
    min_bits: int = 2
    max_bits: int = 8
    ema: float = 0.9
    gmin_quantile: float = 0.9
    warmup_steps: int = 2
    switch_threshold: float = 0.02
    max_cached_steps: int = 8
    live_hysteresis: float = 0.25

    def __post_init__(self):
        if not (1 <= self.min_bits <= self.max_bits <= 8):
            raise ValueError("need 1 <= min_bits <= max_bits <= 8")
        if self.replan_every < 1:
            raise ValueError("replan_every must be >= 1")
        if not (0.0 < self.ema < 1.0):
            raise ValueError("ema must be in (0, 1)")
        if self.switch_threshold < 0.0:
            raise ValueError("switch_threshold must be >= 0")
        if self.max_cached_steps < 1:
            raise ValueError("max_cached_steps must be >= 1")
        if not (0.0 <= self.live_hysteresis < 1.0):
            raise ValueError("live_hysteresis must be in [0, 1)")


class BitPlan(NamedTuple):
    """One allocation's result (host-side Python scalars)."""

    bits: tuple[int, ...]       # per-bucket wire bits
    alphas: tuple[float, ...]   # solver α at the chosen bits (for reports)
    spend_bytes: int            # wire bytes/step of this plan
    budget_bytes: int           # the budget it was solved under
    err: float = 0.0            # predicted size-weighted total error


def _tail_rows(tails) -> list[PowerLawTail]:
    """A stacked PowerLawTail ((B,) fields) or a list of scalar tails, as a
    list of scalar tails."""
    if isinstance(tails, PowerLawTail) and getattr(tails.gamma, "ndim", 0) == 1:
        return [PowerLawTail(*(f[b] for f in tails)) for b in range(tails.gamma.shape[0])]
    return list(tails)


def budget_bytes(cfg: AdaptiveConfig, ccfg: CompressorConfig, sizes: Sequence[int],
                 live_frac: float = 1.0) -> int:
    """Global wire budget in bytes/step over the bucket list: the fixed
    allocation's spend (``wire_budget_mb <= 0``) or ``wire_budget_mb``,
    divided by the expected live fraction of peers."""
    if not 0.0 < live_frac <= 1.0:
        raise ValueError(f"live_frac {live_frac} outside (0, 1]")
    base = int(cfg.wire_budget_mb * (1 << 20)) if cfg.wire_budget_mb > 0 \
        else int(wire_bytes(ccfg, list(sizes)))
    return int(base / live_frac)


def _solve_bucket(tail: PowerLawTail, dens: EmpiricalDensity | None, k: int,
                  ccfg: CompressorConfig, iters: int) -> tuple[float, float]:
    """(α, per-element E_TQ) of one bucket at k bits, as the method's plan
    solves it: α = max|g| for the untruncated methods, Eq. 19's α and the
    Q_N model for tnqsgd and tbqsgd with a density, Eq. 12 and Eq. 11
    otherwise."""
    method = ccfg.method
    if method in ("qsgd", "nqsgd", "dsgd"):
        a = tail.g_max
        if dens is not None and method == "nqsgd":
            return float(a), float(theory.e_tq_nonuniform(tail, dens, a, k))
        return float(a), float(theory.e_tq_uniform(tail, a, k))
    if dens is not None and method in ("tnqsgd", "tbqsgd"):
        a = optimal.solve_alpha_nonuniform(tail, dens, k, iters=iters)
        return float(a), float(theory.e_tq_nonuniform(tail, dens, a, k))
    a = optimal.solve_alpha_uniform(tail, k, iters=iters)
    return float(a), float(theory.e_tq_uniform(tail, a, k))


def predicted_error(tails, sizes: Sequence[int], bits: Sequence[int], ccfg: CompressorConfig,
                    *, dens: Sequence[EmpiricalDensity] | None = None,
                    alpha_iters: int = 10) -> float:
    """Size-weighted total model error of any bit assignment."""
    rows = _tail_rows(tails)
    return sum(_solve_bucket(rows[b], dens[b] if dens is not None else None, int(bits[b]),
                             ccfg, alpha_iters)[1] * sizes[b]
               for b in range(len(sizes)))


def allocate_bits(tails, sizes: Sequence[int], budget: int, ccfg: CompressorConfig, *,
                  dens: Sequence[EmpiricalDensity] | None = None, min_bits: int = 2,
                  max_bits: int = 8, alpha_iters: int = 10) -> BitPlan:
    """Greedy water-filling of bits per bucket: each +1-bit upgrade scored
    by predicted error reduction over extra wire bytes, applied best first
    while it fits ``budget``.  ``min_bits`` everywhere is the floor even if
    it alone overshoots the budget."""
    rows = _tail_rows(tails)
    if len(rows) != len(sizes):
        raise ValueError(f"{len(rows)} tails vs {len(sizes)} bucket sizes")
    if dens is not None and len(dens) != len(sizes):
        raise ValueError(f"{len(dens)} densities vs {len(sizes)} bucket sizes")
    nb = len(sizes)
    err: list[dict[int, float]] = []
    alph: list[dict[int, float]] = []
    for b in range(nb):
        e_row, a_row = {}, {}
        for k in range(min_bits, max_bits + 1):
            a, e = _solve_bucket(rows[b], dens[b] if dens is not None else None, k, ccfg,
                                 alpha_iters)
            e_row[k] = e * sizes[b]
            a_row[k] = a
        err.append(e_row)
        alph.append(a_row)

    def cost(b: int, k: int) -> int:
        return int(wire_bytes(ccfg, sizes[b], k))

    bits = [min_bits] * nb
    spend = sum(cost(b, min_bits) for b in range(nb))
    while True:
        best = None
        for b in range(nb):
            k = bits[b] + 1
            if k > max_bits:
                continue
            dcost = cost(b, k) - cost(b, bits[b])
            if spend + dcost > budget:
                continue
            score = (err[b][bits[b]] - err[b][k]) / max(dcost, 1)
            if best is None or score > best[0]:
                best = (score, b, k, dcost)
        if best is None or best[0] <= 0.0:
            break
        _, b, k, dcost = best
        bits[b] = k
        spend += dcost
    return BitPlan(bits=tuple(bits), alphas=tuple(alph[b][bits[b]] for b in range(nb)),
                   spend_bytes=spend, budget_bytes=int(budget),
                   err=sum(err[b][bits[b]] for b in range(nb)))


class MethodPlan(NamedTuple):
    """A mixed codec plan: per-bucket ``bits_plan`` entries (an int width or
    ``("powersgd", rank)``), plus accounting."""

    entries: tuple               # per-bucket int bits or ("method", rank)
    alphas: tuple[float, ...]    # solver α of the quantized buckets (0 otherwise)
    spend_bytes: int
    budget_bytes: int
    err: float = 0.0


def _density_msq(dens: EmpiricalDensity) -> float:
    """Per-element mean square of |g| under the density: Σ p_k Δ_k mid_k²."""
    edges = dens.edges.to(torch.float32)
    mids = 0.5 * (edges[:-1] + edges[1:])
    widths = edges[1:] - edges[:-1]
    return float(torch.sum(dens.density.to(torch.float32) * widths * mids**2))


def _lowrank_error(msq: float, m: int, rank: int, beta: float) -> float:
    """Per-element predicted powersgd error of an m-element bucket at
    ``rank`` under σ_i² ∝ i^-beta: the share of the mean square beyond the
    first ``rank`` of the matrix's min(rows, cols) singular values."""
    from repro_torch.core import lowrank

    rows, cols = lowrank.matrix_shape(m)
    full = min(rows, cols)
    r = max(1, min(rank, full))
    weights = [i ** -beta for i in range(1, full + 1)]
    return msq * (1.0 - sum(weights[:r]) / sum(weights))


def allocate_plan(tails, sizes: Sequence[int], budget: int, ccfg: CompressorConfig, *,
                  dens: Sequence[EmpiricalDensity] | None = None, min_bits: int = 2,
                  max_bits: int = 8, alpha_iters: int = 10,
                  ranks: Sequence[int] = (1, 2, 4, 8), sv_decay: float = 2.0) -> MethodPlan:
    """:func:`allocate_bits`, then per-bucket ``("powersgd", rank)`` swaps.

    Each quantized bucket is offered its best low-rank entry, scored by
    predicted error reduction over the wire-byte delta (at least 1) under
    :func:`_lowrank_error`; swaps apply best first while they fit the
    budget, and the bytes they free go to +1-bit upgrades of the buckets
    still quantized.  Without ``dens`` (the mean square needs it) the
    result is the quantizer plan.
    """
    base = allocate_bits(tails, sizes, budget, ccfg, dens=dens, min_bits=min_bits,
                         max_bits=max_bits, alpha_iters=alpha_iters)
    entries: list = list(base.bits)
    alphas = list(base.alphas)
    if dens is None:
        return MethodPlan(tuple(entries), tuple(alphas), base.spend_bytes, base.budget_bytes,
                          base.err)
    from repro_torch.core.codecs import bucket_cfg_entry

    rows = _tail_rows(tails)
    nb = len(sizes)

    def q_err(b: int, k: int) -> float:
        return _solve_bucket(rows[b], dens[b], k, ccfg, alpha_iters)[1] * sizes[b]

    def cost(b: int, entry) -> int:
        return int(wire_bytes(ccfg, sizes[b], entry))

    errs = [q_err(b, entries[b]) for b in range(nb)]
    spend = sum(cost(b, entries[b]) for b in range(nb))
    changed = True
    while changed:
        changed = False
        best = None
        for b in range(nb):
            if not isinstance(entries[b], int):
                continue
            msq = _density_msq(dens[b])
            for r in ranks:
                entry = ("powersgd", int(r))
                if bucket_cfg_entry(ccfg, entry).rank != r:
                    continue  # out-of-range rank for this config
                e = _lowrank_error(msq, sizes[b], r, sv_decay) * sizes[b]
                dcost = cost(b, entry) - cost(b, entries[b])
                if spend + dcost > budget or e >= errs[b]:
                    continue
                score = (errs[b] - e) / max(dcost, 1)
                if best is None or score > best[0]:
                    best = (score, b, entry, e, dcost)
        if best is not None:
            _, b, entry, e, dcost = best
            entries[b], errs[b], alphas[b] = entry, e, 0.0
            spend += dcost
            changed = True
    while True:
        best = None
        for b in range(nb):
            if not isinstance(entries[b], int) or entries[b] + 1 > max_bits:
                continue
            k = entries[b] + 1
            dcost = cost(b, k) - cost(b, entries[b])
            if spend + dcost > budget:
                continue
            score = (errs[b] - q_err(b, k)) / max(dcost, 1)
            if best is None or score > best[0]:
                best = (score, b, k, dcost)
        if best is None or best[0] <= 0.0:
            break
        _, b, k, dcost = best
        a, e = _solve_bucket(rows[b], dens[b], k, ccfg, alpha_iters)
        entries[b], errs[b], alphas[b] = k, e * sizes[b], a
        spend += dcost
    return MethodPlan(entries=tuple(entries), alphas=tuple(alphas), spend_bytes=spend,
                      budget_bytes=int(budget), err=sum(errs))
