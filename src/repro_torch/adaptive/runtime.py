"""Replan loop driver: a per-plan cache of step callables keyed on the bit
tuple — the port of ``repro.adaptive.runtime``.

Bit plans are static per step (packed-word counts and codebook sizes
depend on them), so every distinct per-bucket bit tuple maps to its own
``make_train_step`` product, built on first use and reused while hot.  The
JAX package caches compiled steps; here a step is a Python callable, so
the cache saves rebuilding it (and its sync) and keeps the JAX package's
LRU bound (``max_cached_steps``) and switching rule.  Between replans the
stepper dispatches to the cached step; at a replan boundary it gathers
every rank's telemetry row (one all-gather per field over the mesh, the
counterpart of JAX pulling the stacked state to the host), merges the
rows (on a model axis, model rank 0's merge, the shard whose buffer a
host read of JAX's state returns, so every model shard adopts the same
bits), estimates tails and densities, re-solves the allocation and switches
only when the new plan's predicted error beats the *current* plan's (under
the same fresh tails) by ``switch_threshold``: hysteresis against
noisy-tail oscillation.  Under an elastic schedule the budget is re-based
on the expected live fraction of the next window, past
``live_hysteresis``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any

from repro_torch.core import prng
from repro_torch.dist import compat, sharding
from repro_torch.dist import train_step as tsmod
from repro_torch.dist.train_step import TrainStepConfig, make_train_step
from repro_torch.elastic.schedule import expected_live_fraction

from . import telemetry
from .controller import BitPlan, allocate_bits, budget_bytes, predicted_error


class AdaptiveStepper:
    """Owns the telemetry state layout, the bit plan, and the step cache.

    ``stepper.step(params, opt_state, ef_state, tstate, batch, i)`` runs one
    training step (pass ``ef_state=None`` when EF is off) and returns
    ``(params, opt_state, ef_state, tstate, metrics)``; replans fire every
    ``ts.adaptive.replan_every`` calls once the telemetry has warmed up.
    The current plan is exposed as ``stepper.plan`` (a
    :class:`~repro_torch.adaptive.controller.BitPlan`), ``None`` until the
    first replan — before that the uniform ``ts.compressor.bits`` plan runs.
    ``mesh`` is the mesh every rank builds its stepper on; ``params_like``
    this rank's params (its model shard's slices), or None for the meta
    init cut by the mesh's specs.

    Observability hooks (both optional, keyword-only): ``obs`` is a
    :class:`repro_torch.obs.SpanRecorder` — the replan path (telemetry
    merge + tail fit + allocation, the host-side stall candidate) runs
    under an ``adaptive.replan`` span; ``drift`` is a
    :class:`repro_torch.obs.DriftMonitor` fed the freshly estimated
    per-bucket tails at every replan, so a Hill estimate railing out of the
    power-law regime raises a structured warning the moment the controller
    would have consumed it.  The hooks only observe: every rank gathers
    the telemetry whether or not it holds them.
    """

    # class-level defaults so stepper shells built without __init__ (the
    # stubbed-builder tests) still replan cleanly
    obs = None
    drift = None
    mesh = None
    _live_frac = 1.0
    _n_dp = 1

    def __init__(self, cfg, mesh: compat.Mesh, opt, ts: TrainStepConfig, batch0,
                 params_like: Any = None, *, obs: Any = None, drift: Any = None):
        if ts.adaptive is None:
            raise ValueError("AdaptiveStepper needs TrainStepConfig.adaptive set")
        if params_like is None:
            from repro_torch.models import transformer

            # shapes only: the meta device allocates nothing
            # repro: allow REPRO204 (a meta draw has no values: the key shapes nothing)
            params_like = transformer.init_lm(prng.key(0), cfg, device="meta")
            if mesh is not None and mesh.model_size > 1:
                params_like = sharding.shard_tree(params_like, sharding.lm_pspecs(cfg, mesh),
                                                  mesh)
        # The plan/telemetry hot loop never full-sorts: force the histogram
        # quantile for g_min unless the caller already chose.
        if not ts.compressor.approx_gmin:
            ts = dataclasses.replace(
                ts, compressor=dataclasses.replace(ts.compressor, approx_gmin=True))
        self.ts = ts
        self.obs, self.drift = obs, drift
        self.cfg, self.mesh, self.opt = cfg, mesh, opt
        self.batch0 = batch0
        self.params_like = params_like
        self._cache: collections.OrderedDict[tuple[int, ...], Any] = collections.OrderedDict()
        self.plan: BitPlan | None = None
        self.tails = None  # last telemetry-estimated stacked PowerLawTail
        # Elastic: budget re-base factor — the expected live fraction last
        # adopted past ``live_hysteresis`` (1.0 = full participation).
        self._live_frac = 1.0
        self._n_dp = math.prod(mesh.dp_sizes)
        # this rank's bucket sizes: the model-local slices of its params
        self.sizes = tsmod.local_bucket_sizes(params_like, ts)
        self.bits = (ts.compressor.bits,) * len(self.sizes)
        self._cache[self.bits] = self._build(None)

    def _build(self, bits: tuple[int, ...] | None):
        ts_b = dataclasses.replace(self.ts, bits_plan=bits)
        return make_train_step(self.cfg, self.mesh, self.opt, ts_b, self.batch0,
                               params_like=self.params_like)

    def _step_for(self, bits: tuple[int, ...]):
        if bits not in self._cache:
            self._cache[bits] = self._build(bits)
        self._cache.move_to_end(bits)
        while len(self._cache) > self.ts.adaptive.max_cached_steps:
            self._cache.popitem(last=False)
        return self._cache[bits]

    def init_telemetry(self) -> Any:
        return tsmod.init_telemetry_state(self.params_like, self.ts)

    @property
    def budget(self) -> int:
        return budget_bytes(self.ts.adaptive, self.ts.compressor, self.sizes,
                            live_frac=self._live_frac)

    def _merged(self, tstate) -> telemetry.TelemetryState:
        """Every client's telemetry row gathered over the manual axes (a
        stepper without a mesh holds the only row) and merged
        (``aggregate_peers``); on a model axis, model rank 0's merge."""
        if self.mesh is None:
            rows = telemetry.stack_rows([tstate])
        else:
            dp = self.mesh.dp_axes
            rows = telemetry.TelemetryState(*(compat.all_gather_stacked(f, self.mesh, dp)
                                              for f in tstate))
        merged = telemetry.aggregate_peers(rows)
        if self.mesh is not None and self.mesh.model_size > 1:
            merged = type(merged)(*(compat.all_gather_stacked(f, self.mesh, "model")[0]
                                    for f in merged))
        return merged

    def replan(self, tstate: Any, step: int = 0) -> BitPlan:
        """Merge peer telemetry, estimate tails/densities, re-solve bits, and
        adopt the new plan only past the hysteresis margin (the first replan
        away from the uniform bootstrap always adopts)."""
        if self.obs is not None:
            with self.obs.span("adaptive.replan"):
                return self._replan(tstate, step)
        return self._replan(tstate, step)

    def _replan(self, tstate: Any, step: int = 0) -> BitPlan:
        acfg = self.ts.adaptive
        if getattr(self.ts, "elastic", None) is not None:
            # Re-base the budget on the expected live fraction over the
            # upcoming window (the same counter hash the step evaluates,
            # replayed on the host); the relative hysteresis keeps a single
            # flap from thrashing the step cache through a budget change.
            frac = expected_live_fraction(self.ts.elastic, self._n_dp, step,
                                          acfg.replan_every)
            if abs(frac - self._live_frac) > acfg.live_hysteresis * self._live_frac:
                self._live_frac = frac
        merged = self._merged(tstate)
        if float(merged.steps) < acfg.warmup_steps:
            return self.plan if self.plan is not None else BitPlan(
                self.bits, (), 0, self.budget)
        tails = telemetry.estimate_tails(merged, gmin_quantile=acfg.gmin_quantile)
        dens = telemetry.estimate_densities(merged)
        self.tails = tails
        if self.drift is not None:
            self.drift.check_tails(tails, step=int(merged.steps))
        plan = allocate_bits(tails, self.sizes, self.budget, self.ts.compressor,
                             dens=dens, min_bits=acfg.min_bits, max_bits=acfg.max_bits,
                             alpha_iters=self.ts.compressor.alpha_iters)
        if plan.bits != self.bits and self.plan is not None:
            e_current = predicted_error(tails, self.sizes, self.bits,
                                        self.ts.compressor, dens=dens,
                                        alpha_iters=self.ts.compressor.alpha_iters)
            if plan.err > e_current * (1.0 - acfg.switch_threshold):
                # not enough predicted gain to switch: keep the current plan
                return self.plan
        self.plan, self.bits = plan, plan.bits
        return plan

    def step(self, params, opt_state, ef_state, tstate, batch, i: int):
        acfg = self.ts.adaptive
        if i and i % acfg.replan_every == 0:
            self.replan(tstate, step=i)
        fn = self._step_for(self.bits)
        if self.ts.error_feedback:
            p, o, e, t, m = fn(params, opt_state, ef_state, tstate, batch, i)
        else:
            p, o, t, m = fn(params, opt_state, tstate, batch, i)
            e = None
        return p, o, e, t, m
