"""The gradient sync of one data-parallel rank — the sync region of
``repro.dist.train_step``.

:class:`TrainStepConfig` carries the JAX package's fields and checks but
``streamed``, which only the LM train step reads.  :func:`make_sync_fn` is
the per-rank counterpart of ``_make_sync_fn``: the JAX package runs the
sync inside a fully manual ``shard_map`` over stacked ``(n_dp, …)``
arrays; here every rank of a :class:`~repro_torch.dist.compat.Mesh`
calls it on its own rows, and the collectives cross the ``torch.distributed``
groups of the mesh.  The mesh is data-parallel: its axes are all dp axes
(one model shard), so the JAX package's model-axis ``psum`` of the metric
sums is the identity here.  The sync returns no gradient norm: the JAX
package's ``metrics_gnorm`` output is read only by its LM train step.

``local_bucket_sizes`` and ``init_ef_state`` give this rank's bucket sizes
and EF rows of the JAX package's state arrays.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.adaptive import telemetry as adaptive_telemetry
from repro_torch.adaptive.controller import AdaptiveConfig
from repro_torch.core import compressors, prng
from repro_torch.core.codecs import (bucket_cfgs, bucket_state_sizes, get_codec,
                                     size_adaptive_plan)
from repro_torch.core.compressors import CompressorConfig
from repro_torch.elastic.schedule import ElasticConfig
from repro_torch.obs import metrics as obs_metrics

from . import compat
from . import sharded_codec as sc

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


# -- the gradient sync of one rank -------------------------------------------


def _sync_leaf(ts: TrainStepConfig, g: torch.Tensor, key: torch.Tensor, mesh: compat.Mesh,
               dp: tuple) -> torch.Tensor:
    """One leaf through the per-leaf codec (``bucket_mb=0``)."""
    if ts.sync == "dsgd" or ts.compressor.method == "dsgd":
        # the replay's bits: the peer sum times the float32 1/n
        return compat.psum(g, mesh, dp) * (1.0 / compat.axis_size(mesh, dp))
    cfg = ts.compressor
    if ts.sync == "faithful":
        return sc.faithful_ring_mean(cfg, g, mesh, dp, key)
    if ts.sync == "two_phase" or len(dp) == 1:
        return sc.two_phase_mean(cfg, g, mesh, dp, key)
    # hierarchical: two-phase inside the innermost data axis under the key
    # folded by the full dp index, then the pod means faithfully across pods
    pod_axes, data_axis = dp[:-1], dp[-1:]
    k1, k2 = prng.split(key)
    g = sc.two_phase_mean(cfg, g, mesh, data_axis, sc._peer_key(k1, mesh, dp))
    return sc.faithful_ring_mean(cfg, g, mesh, pod_axes, k2)


def _sync_buckets(ts: TrainStepConfig, vals: list, key: torch.Tensor, mesh: compat.Mesh,
                  dp: tuple, ef=None, tstate=None, live=None):
    """Bucketed sync of this rank's flat leaf list.

    Returns ``(mean_leaves, state_rows, new_telemetry, metric_sums)``:
    ``state_rows`` this rank's EF rows (None without error feedback),
    ``metric_sums`` the ``obs.metrics.local_sums`` pair under
    ``ts.metrics_compression`` (else None).  Each bucket is read once by the
    one-pass EF correction and statistics (``correct_stats``: K1 with EF,
    else K10), whose statistics plan the codec and feed the telemetry; each
    phase of the mode moves one fused wire tensor for all buckets.  dsgd
    adds every bucket over the dp group (one ``all_reduce`` a bucket).
    ``live`` is the replicated (n,) float 0/1 mask over the dp ranks
    (``elastic.live_mask``).
    """
    cfg = ts.compressor
    bp = compressors.plan_buckets([v.numel() for v in vals], ts.bucket_elements)
    buckets = compressors.bucket_concat(vals, bp)
    compressed = not (ts.sync == "dsgd" or cfg.method == "dsgd")
    bits = size_adaptive_plan(cfg, ts.bits_plan, bp.sizes, ts.fp16_threshold)
    # split each EF row into the residual and the codec's aux tail
    cfgs = bucket_cfgs(cfg, bp.n_buckets, bits)
    extras = [get_codec(c.method).state_extra(c, g.numel()) for c, g in zip(cfgs, buckets)]
    aux = None
    if ef is not None and any(extras):
        aux = [ef[b][g.numel():] if x else None for b, (g, x) in enumerate(zip(buckets, extras))]
        ef = [ef[b][:g.numel()] if x else ef[b] for b, (g, x) in enumerate(zip(buckets, extras))]
    stats = None
    if compressed or tstate is not None:
        corrected, stats = [], []
        for b, g in enumerate(buckets):
            c, st = adaptive_telemetry.correct_stats(g, ef[b] if ef is not None else None)
            corrected.append(c)
            stats.append(st)
        buckets = corrected
    new_t = None
    if tstate is not None:
        new_t = adaptive_telemetry.update_telemetry(tstate, buckets, decay=ts.adaptive.ema,
                                                    stats=stats)
    if not compressed:
        n = compat.axis_size(mesh, dp)
        if live is None:
            means = [compat.psum(b, mesh, dp) / n for b in buckets]
        else:
            # dead contributions zeroed inside the same per-bucket sum, then
            # the replay's float32 1/n and the live renormalization
            self_live = live[compat.flat_axis_index(mesh, dp)]
            scale = sc._live_scale(live, n)
            means = [compat.psum(b * self_live, mesh, dp) * (1.0 / n) * scale for b in buckets]
        resids = None
    elif ts.sync == "faithful":
        means, resids = sc.bucketed_faithful_ring_mean(cfg, buckets, mesh, dp, key, bits, stats,
                                                       aux, live)
    elif ts.sync == "two_phase" or len(dp) == 1:
        means, resids = sc.bucketed_two_phase_mean(cfg, buckets, mesh, dp, key, bits, stats,
                                                   aux, live)
    else:
        means, resids = sc.bucketed_hierarchical_mean(cfg, buckets, mesh, dp, key, bits, stats,
                                                      aux, live)
    mean_leaves = compressors.bucket_split(means, bp, [tuple(v.shape) for v in vals])
    cm = None
    if ts.metrics_compression:
        # the fused encode's residual is the realized error of this rank's
        # own transmission: the sums need no collective
        cm = obs_metrics.local_sums(cfgs, buckets, stats, resids, ef, compressed)
    if not ts.error_feedback:
        resids = None
    return mean_leaves, resids, new_t, cm


def make_sync_fn(ts: TrainStepConfig, mesh: compat.Mesh, grads_like):
    """This rank's gradient sync over every axis of ``mesh``.

    ``grads_like``: this rank's gradient leaves (or tensors of their
    shapes), in ``jax.tree.leaves`` order.  Returns ``sync(grads, key[,
    live][, ef][, tstate]) -> (mean[, new_ef][, new_tstate][, metrics])``,
    the argument and result order of the JAX package's ``_make_sync_fn``
    with ``metrics_gnorm=False``, each stacked ``(n_dp, …)`` array of it
    this rank's row:

    - ``grads``: the leaves; ``mean``: the synced mean leaves, bitwise
      equal on every rank for every compressed mode;
    - ``key``: the step key, the same on every rank;
    - ``live`` (with ``ts.elastic``): the replicated (n_dp,) float 0/1 mask,
      the same on every rank (``elastic.live_mask``: no mask collective);
    - ``ef`` (with ``ts.error_feedback``): this rank's EF rows, one per
      bucket (:func:`init_ef_state`);
    - ``tstate`` (with ``ts.adaptive``): this rank's telemetry row
      (``adaptive.telemetry.init_telemetry`` over the buckets);
    - ``metrics`` (with ``ts.metrics_compression``): this rank's
      :class:`~repro_torch.obs.metrics.CompressionMetrics`, (B,) leaves.
    """
    dp = mesh.axis_names
    shapes = [tuple(x.shape) for x in grads_like]

    def sync(grads, key, *extras):
        idx = 0
        ef = tstate = live = None
        if ts.elastic is not None:
            live, idx = extras[idx], idx + 1
        if ts.error_feedback:
            ef, idx = extras[idx], idx + 1
        if ts.adaptive is not None:
            tstate, idx = extras[idx], idx + 1
        if idx != len(extras):
            raise TypeError(f"sync takes {idx} state arguments after the key under this "
                            f"config, got {len(extras)}")
        vals = list(grads)
        if [tuple(g.shape) for g in vals] != shapes:
            raise ValueError(f"gradient shapes {[tuple(g.shape) for g in vals]} are not "
                             f"{shapes}")
        if ts.bucket_mb > 0:
            out, resid, new_t, cm = _sync_buckets(
                ts, vals, key, mesh, dp, None if ef is None else list(ef), tstate, live)
        else:
            out = [_sync_leaf(ts, g, prng.fold_in(key, i), mesh, dp)
                   for i, g in enumerate(vals)]
            resid = new_t = cm = None
        result = [out]
        if ts.error_feedback:
            result.append(tuple(resid))
        if ts.adaptive is not None:
            result.append(new_t)
        if cm is not None:
            result.append(obs_metrics.finalize(*cm, 1))
        return tuple(result) if len(result) > 1 else result[0]

    return sync


def local_bucket_sizes(params_like, ts: TrainStepConfig) -> tuple[int, ...]:
    """Element counts of the codec's buckets as one rank sees them: the
    data-parallel mesh shards no leaf, so ``plan_buckets`` of the sizes of
    ``params_like`` (the parameter leaves)."""
    return tuple(compressors.plan_buckets([x.numel() for x in params_like],
                                          ts.bucket_elements).sizes)


def init_ef_state(params_like, ts: TrainStepConfig) -> tuple:
    """This rank's zero bucket-resident EF rows: one fp32 row per bucket of
    ``m + state_extra`` elements (the powersgd Q factor after the residual),
    with the fp16 tier applied, on the device of the parameters."""
    sizes = local_bucket_sizes(params_like, ts)
    plan = size_adaptive_plan(ts.compressor, ts.bits_plan, sizes, ts.fp16_threshold)
    device = params_like[0].device
    return tuple(torch.zeros(s, dtype=torch.float32, device=device)
                 for s in bucket_state_sizes(ts.compressor, sizes, plan))
