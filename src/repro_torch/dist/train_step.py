"""The train step of one rank on a data x model mesh — the port of
``repro.dist.train_step``.

:class:`TrainStepConfig` carries the JAX package's fields and checks.
:func:`make_sync_fn` is the per-rank counterpart of ``_make_sync_fn``: the
JAX package runs the sync inside a fully manual ``shard_map`` over stacked
``(n_dp, …)`` arrays; here every rank of a
:class:`~repro_torch.dist.compat.Mesh` calls it on its own rows, and the
collectives cross the ``torch.distributed`` groups of the mesh.  The sync
crosses the manual (pod and data) axes only.  On a model axis each rank
holds its model shard's slices of the split leaves and the whole of the
others, so it buckets, quantizes and error-feeds its own composition; the
gnorm and the compression-metric sums share one model-group sum, as JAX
fuses them into one ``psum``.

:func:`make_train_step` is the LM zoo's step on that mesh (or on one
process with ``mesh=None``): each rank is the client of its index over the
manual axes, takes its row of the global batch (:func:`_client_batch`),
computes its loss and gradients with ``torch.autograd`` (or the
layer-streamed schedule, :func:`_streamed_loss_and_grads`) under the
mesh's ``dist.sharding.axis_rules`` (the model axis's sums inside the
layers), syncs the float32 gradients through :func:`make_sync_fn` under
the step key ``fold_in(key(0x5EED), step)`` (the same on every model
shard; the peer index folded in is the data/pod index) and applies the
optimizer update to its own slices.

Outputs that JAX declares replicated over the model axis (the mean of a
leaf the specs leave whole, the telemetry rows, the metrics, the gnorm)
are computed by each model shard from its own buckets, so they may differ
in their last bits from shard to shard, as each JAX device keeps its own
buffer.  Rank (d, m) equals JAX device (d, m) leaf for leaf; a host read
of JAX's takes device (0, 0)'s, and so do the port's checkpoints and
replans (model rank 0's).  The gnorm counts a leaf held whole on every
model shard ``n_model`` times, as JAX's ``psum`` does.

``local_bucket_sizes``, ``init_ef_state`` and ``init_telemetry_state``
give this rank's bucket sizes, EF rows and telemetry row of the JAX
package's state arrays (:func:`ef_rank_rows` and :func:`ef_stacked` carry
EF state across the two layouts).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.profiler import record_function

from repro_torch.adaptive import telemetry as adaptive_telemetry
from repro_torch.adaptive.controller import AdaptiveConfig
from repro_torch.core import compressors, prng
from repro_torch.core.codecs import (bucket_cfgs, bucket_state_sizes, get_codec,
                                     size_adaptive_plan)
from repro_torch.core.compressors import CompressorConfig
from repro_torch.elastic.schedule import ElasticConfig, live_mask
from repro_torch.models import transformer
from repro_torch.models.smallnet import tree_leaves, tree_unflatten
from repro_torch.obs import metrics as obs_metrics

from . import compat, sharding
from . import sharded_codec as sc

SYNC_MODES = ("dsgd", "two_phase", "hierarchical", "faithful")

_KEY_SEED = 0x5EED


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """``bucket_mb > 0`` coalesces the gradient leaves into ~``bucket_mb``-MB
    fp32 buckets with one codebook each; ``error_feedback`` carries a
    bucket-resident (n_clients, bucket_elems) EF residual from step to
    step; ``adaptive`` keeps a per-client telemetry state the same way
    (``dist.reference.reference_sync_state(tstate=...)``, decay
    ``adaptive.ema``); ``bits_plan`` gives each bucket its own width;
    buckets of at most ``fp16_threshold`` elements ship raw fp16 (0 =
    off); ``metrics_gnorm`` (on by default) makes the sync return the
    global gradient norm, computed from the flat mean buckets;
    ``metrics_compression`` makes it return every peer's
    ``obs.metrics.CompressionMetrics``; ``elastic`` is the deterministic
    partial-participation schedule whose per-step live mask
    (``elastic.live_mask``) the sync renormalizes the peer mean over,
    dropped peers' EF rows accumulating.  ``bucket_mb=0`` selects the
    per-leaf codec, which takes none of these.  ``streamed`` swaps the
    train step's one-shot backward for the layer-streamed schedule."""

    sync: str = "dsgd"
    streamed: bool = False
    compressor: CompressorConfig = dataclasses.field(default_factory=CompressorConfig)
    bucket_mb: float = 4.0
    error_feedback: bool = False
    adaptive: AdaptiveConfig | None = None
    bits_plan: tuple[int, ...] | None = None
    metrics_gnorm: bool = True
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

    Returns ``(mean_leaves, state_rows, new_telemetry, mean_buckets,
    metric_sums)``: ``state_rows`` this rank's EF rows (None without error
    feedback), ``mean_buckets`` the flat means the gnorm is taken from,
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
    return mean_leaves, resids, new_t, means, cm


def _sum_of_squares(flat: list) -> torch.Tensor:
    return sum(torch.sum(torch.square(m.to(torch.float32))) for m in flat)


def global_norm(flat: list) -> torch.Tensor:
    """sqrt of the sum over ``flat`` (the mean buckets, or the mean leaves of
    the per-leaf codec) of each one's sum of squares, in float32, in their
    order: the JAX package's gnorm."""
    return torch.sqrt(_sum_of_squares(flat))


def make_sync_fn(ts: TrainStepConfig, mesh: compat.Mesh, grads_like):
    """This rank's gradient sync over every axis of ``mesh``.

    ``grads_like``: this rank's gradient leaves (or tensors of their
    shapes), in ``jax.tree.leaves`` order.  Returns ``sync(grads, key[,
    live][, ef][, tstate]) -> (mean[, new_ef][, new_tstate][, gnorm][,
    metrics])``, the argument and result order of the JAX package's
    ``_make_sync_fn``, each stacked ``(n_dp, …)`` array of it this rank's
    row:

    - ``grads``: the leaves; ``mean``: the synced mean leaves, bitwise
      equal on every rank for every compressed mode;
    - ``key``: the step key, the same on every rank;
    - ``live`` (with ``ts.elastic``): the replicated (n_dp,) float 0/1 mask,
      the same on every rank (``elastic.live_mask``: no mask collective);
    - ``ef`` (with ``ts.error_feedback``): this rank's EF rows, one per
      bucket (:func:`init_ef_state`);
    - ``tstate`` (with ``ts.adaptive``): this rank's telemetry row
      (:func:`init_telemetry_state`);
    - ``gnorm`` (with ``ts.metrics_gnorm``): :func:`global_norm` of the mean
      buckets (the mean leaves per leaf), a float32 scalar;
    - ``metrics`` (with ``ts.metrics_compression``): this rank's
      :class:`~repro_torch.obs.metrics.CompressionMetrics`, (B,) leaves.

    On a model axis the leaves are this rank's model-local slices, the
    collectives cross the manual axes, and the gnorm's square and the
    metric sums are summed over the model group in one collective.
    """
    dp = mesh.dp_axes
    n_model = mesh.model_size
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
            out, resid, new_t, gsrc, cm = _sync_buckets(
                ts, vals, key, mesh, dp, None if ef is None else list(ef), tstate, live)
        else:
            out = [_sync_leaf(ts, g, prng.fold_in(key, i), mesh, dp)
                   for i, g in enumerate(vals)]
            resid = new_t = cm = None
            gsrc = out
        result = [out]
        if ts.error_feedback:
            result.append(tuple(resid))
        if ts.adaptive is not None:
            result.append(new_t)
        gsq = _sum_of_squares(gsrc) if ts.metrics_gnorm else None
        if cm is not None:
            # one model-group sum for the metric sums and the gnorm's square
            sums, static = cm
            if n_model > 1:
                vec = sums.reshape(-1)
                if gsq is not None:
                    vec = torch.cat([vec, gsq[None]])
                vec = compat.psum(vec, mesh, "model")
                if gsq is not None:
                    gsq, vec = vec[-1], vec[:-1]
                sums = vec.reshape(sums.shape)
            cm = obs_metrics.finalize(sums, static, n_model)
        elif gsq is not None and n_model > 1:
            gsq = compat.psum(gsq, mesh, "model")
        if gsq is not None:
            result.append(torch.sqrt(gsq))
        if cm is not None:
            result.append(cm)
        return tuple(result) if len(result) > 1 else result[0]

    return sync


def _leaf_list(params_like) -> list:
    """A params tree (nested dicts) as its ``jax.tree.leaves``-ordered
    leaves; a list passes through."""
    return tree_leaves(params_like) if isinstance(params_like, dict) else list(params_like)


def _local_sizes(params_like, mesh, pspecs) -> list:
    """Each leaf's element count on one rank: ``params_like`` as given (this
    rank's slices), or, with ``pspecs``, the full leaves divided by the
    model shards their specs split them over."""
    leaves = _leaf_list(params_like)
    if pspecs is None:
        return [x.numel() for x in leaves]
    specs = sharding.tree_leaves(pspecs)
    sizes = []
    for x, spec in zip(leaves, specs, strict=True):
        div = math.prod(math.prod(mesh.shape[a] for a in axes)
                        for _, axes in sharding.model_split(spec, mesh))
        sizes.append(x.numel() // div)
    return sizes


def local_bucket_sizes(params_like, ts: TrainStepConfig, mesh=None,
                       pspecs=None) -> tuple[int, ...]:
    """Element counts of the codec's buckets as one rank sees them:
    ``plan_buckets`` of its leaves' local sizes (see :func:`_local_sizes`:
    this rank's params or tensors of their shapes, or the full ones with
    the ``mesh`` and its ``pspecs``, as JAX's takes them)."""
    return tuple(compressors.plan_buckets(_local_sizes(params_like, mesh, pspecs),
                                          ts.bucket_elements).sizes)


def init_ef_state(params_like, ts: TrainStepConfig, mesh=None, pspecs=None) -> tuple:
    """This rank's zero bucket-resident EF rows: one fp32 row per bucket of
    ``m + state_extra`` elements (the powersgd Q factor after the residual),
    with the fp16 tier applied, on the device of the parameters.  JAX's
    state is ``(n_dp, n_model · row)`` a bucket: rank (d, m) holds row d's
    segment m (:func:`ef_rank_rows`)."""
    sizes = local_bucket_sizes(params_like, ts, mesh, pspecs)
    plan = size_adaptive_plan(ts.compressor, ts.bits_plan, sizes, ts.fp16_threshold)
    device = _leaf_list(params_like)[0].device
    return tuple(torch.zeros(s, dtype=torch.float32, device=device)
                 for s in bucket_state_sizes(ts.compressor, sizes, plan))


def ef_rank_rows(ef_stacked, client: int, model_index: int, n_model: int) -> tuple:
    """Rank (client, model_index)'s EF rows out of the JAX package's
    stacked layout (one ``(n_dp, n_model · row)`` array a bucket)."""
    return tuple(e[client].reshape(n_model, -1)[model_index].clone() for e in ef_stacked)


def ef_stacked(rows: list, n_dp: int, n_model: int) -> tuple:
    """The JAX package's stacked EF layout from every rank's rows
    (``rows[d · n_model + m]``: rank (d, m)'s, as :func:`init_ef_state`
    gives them)."""
    return tuple(torch.stack([torch.cat([rows[d * n_model + m][b] for m in range(n_model)])
                              for d in range(n_dp)])
                 for b in range(len(rows[0])))


def init_telemetry_state(params_like, ts: TrainStepConfig, mesh=None, pspecs=None):
    """This rank's zero telemetry row over the bucket plan (the JAX
    package's stacked state has one such row per client), on the device of
    the parameters."""
    n_buckets = len(local_bucket_sizes(params_like, ts, mesh, pspecs))
    return adaptive_telemetry.init_telemetry(n_buckets, device=_leaf_list(params_like)[0].device)


def _opt_specs(opt_state_like, params_like, pspecs):
    """Optimizer-state specs, as the JAX package's: each state leaf is
    shape-matched against the param leaves in cyclic order (momentum
    mirrors them once, AdamW twice); a match takes the param's spec,
    anything else (a scalar) ``P()``; a partial cycle replicates the whole
    state."""
    p_shapes = [tuple(x.shape) for x in _leaf_list(params_like)]
    spec_leaves = sharding.tree_leaves(pspecs)
    leaves = sharding.tree_leaves(opt_state_like)
    n = len(p_shapes)
    out, cursor = [], 0
    for leaf in leaves:
        if n and hasattr(leaf, "shape") and tuple(leaf.shape) == p_shapes[cursor % n]:
            out.append(spec_leaves[cursor % n])
            cursor += 1
        else:
            out.append(sharding.P())
    if n and cursor % n:
        return sharding.tree_unflatten(opt_state_like, [sharding.P() for _ in leaves])
    return sharding.tree_unflatten(opt_state_like, out)


# -- the loss and its gradients ----------------------------------------------


def _grad_leaves(params: dict) -> tuple[list, dict]:
    """Fresh autograd leaves for the params' tensors, and the tree of them."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    return leaves, tree_unflatten(params, leaves)


def _grads(outputs, inputs: list, grad_outputs=None) -> list:
    """``torch.autograd.grad``, zeros for inputs the outputs do not reach
    (as JAX's gradients of unused params are)."""
    return list(torch.autograd.grad(outputs, inputs, grad_outputs, allow_unused=True,
                                    materialize_grads=True))


def _loss_and_grads(cfg, params: dict, batch, streamed: bool):
    """One client's loss (a float32 scalar) and gradient tree (each leaf in
    its param's dtype): ``autograd`` through ``transformer.loss_fn``, or the
    layer-streamed schedule."""
    if streamed:
        return _streamed_loss_and_grads(cfg, params, batch)
    leaves, tree = _grad_leaves(params)
    loss = transformer.loss_fn(cfg, tree, batch)
    return loss.detach(), tree_unflatten(params, _grads(loss, leaves))


def _stack_trees(trees: list) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _streamed_loss_and_grads(cfg, full_params: dict, batch):
    """Layer-streamed loss and grads: a forward over the units without
    autograd saving each unit's input, the head's backward, then each
    unit's backward in reverse (its forward recomputed), so one unit's
    backward graph is alive at a time.  The same math as the plain
    schedule: the head's and the embedding's gradients of the outer params
    are added (head + embed, as JAX adds them), the units' gradients
    stacked on the unit axis."""
    if cfg.enc_dec:
        raise ValueError("the streamed schedule runs decoder-only stacks (make_train_step "
                         "takes the plain one for an encoder-decoder)")
    outer = transformer.outer_params(full_params)
    positions = transformer._positions_for(cfg, batch)
    _, units = transformer._decoder_descs(cfg)
    o_leaves, o_tree = _grad_leaves(outer)
    h0 = transformer.embed_fn(cfg, o_tree, batch)
    blocks = transformer._units(full_params["blocks"], units)

    h_ins, aux_total = [], 0.0
    with torch.no_grad():
        h = h0.detach()
        for p_u in blocks:
            h_ins.append(h)
            h, aux = transformer.unit_fn(cfg, p_u, h, positions)
            aux_total = aux_total + aux
    h_final = h.requires_grad_(True)
    xent = transformer.head_fn(cfg, o_tree, h_final, batch)
    loss = xent + transformer.AUX_LOSS_WEIGHT * aux_total
    *g_head, g_h = _grads(xent, o_leaves + [h_final])

    aux_w = torch.tensor(transformer.AUX_LOSS_WEIGHT, dtype=torch.float32, device=h0.device)
    g_blocks = [None] * units
    for i in reversed(range(units)):
        p_leaves, p_tree = _grad_leaves(blocks[i])
        h_in = h_ins[i].requires_grad_(True)
        h2, aux = transformer.unit_fn(cfg, p_tree, h_in, positions)
        outs, g_outs = [h2], [g_h]
        if isinstance(aux, torch.Tensor) and aux.requires_grad:
            outs.append(aux)
            g_outs.append(aux_w)
        *g_p, g_h = _grads(outs, p_leaves + [h_in], g_outs)
        g_blocks[i] = tree_unflatten(blocks[i], g_p)
    g_embed = _grads(h0, o_leaves, g_h)
    grads = tree_unflatten(outer, [a + b for a, b in zip(g_head, g_embed)])
    grads["blocks"] = _stack_trees(g_blocks)
    return loss.detach(), grads


# -- make_train_step ---------------------------------------------------------


def _client_batch(batch, n_clients: int):
    """Split the global batch into per-client slices: each field reshaped
    to (…, n_clients, B / n_clients, …) on its batch axis, and the axis of
    the client index of each field (None for an absent one)."""

    def split(x, batch_dim: int):
        if x is None:
            return None
        b = x.shape[batch_dim]
        return x.reshape(tuple(x.shape[:batch_dim]) + (n_clients, b // n_clients)
                         + tuple(x.shape[batch_dim + 1:]))

    pos_dim = 1 if (batch.positions is not None and batch.positions.dim() == 3) else 0
    split_batch = transformer.Batch(
        tokens=split(batch.tokens, 0),
        labels=split(batch.labels, 0),
        positions=split(batch.positions, pos_dim),
        patches=split(batch.patches, 0),
        frames=split(batch.frames, 0),
    )
    axes = transformer.Batch(
        tokens=0, labels=0,
        positions=pos_dim if batch.positions is not None else None,
        patches=0 if batch.patches is not None else None,
        frames=0 if batch.frames is not None else None,
    )
    return split_batch, axes


def client_row(split_batch, axes, client: int):
    """Client ``client``'s batch out of :func:`_client_batch`'s split."""
    return transformer.Batch(*(None if x is None else x.select(ax, client)
                               for x, ax in zip(split_batch, axes)))


def _full(x, n: int) -> torch.Tensor:
    """A float32 scalar replicated (n,), as the JAX metrics are."""
    return x.reshape(1).to(torch.float32).expand(n).clone()


def make_train_step(cfg, mesh: compat.Mesh | None, opt, ts: TrainStepConfig, batch,
                    params_like=None):
    """This rank's train step for one configuration.

    ``mesh``: a :class:`~repro_torch.dist.compat.Mesh` (this process is the
    client of its index over the manual axes and holds its model shard's
    slices of the params, ``dist.sharding.shard_tree`` by the step's
    ``pspecs``), or None for one process and no sync.  ``batch``: a global
    batch of the shapes the step will be given (its batch must split evenly
    over the clients).  ``params_like``: this rank's params tree or tensors
    of its shapes (default: the params of the first call).  The step's
    ``pspecs`` attribute is the params' PartitionSpec tree (JAX's second
    result; None without a mesh).

    ``step_fn(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``; with ``ts.error_feedback`` the EF rows
    (:func:`init_ef_state`) and with ``ts.adaptive`` the telemetry row
    (:func:`init_telemetry_state`) ride in the slots after ``opt_state``,
    in that order, in the arguments and the results, as in the JAX
    package.  ``step`` is the host int step number.  Metrics follow the
    JAX package's contract: ``loss`` is the mean client loss (a ``psum``
    of each rank's loss times the float32 1/n) and ``gnorm`` (with
    ``ts.metrics_gnorm``) the synced mean's norm, both (n_dp,) float32 and
    replicated; ``compression`` (with ``ts.metrics_compression``) every
    rank's CompressionMetrics, (n_dp, n_buckets) leaves; ``live`` and
    ``live_count`` with ``ts.elastic``.
    """
    b = batch.tokens.shape[0]
    pspecs, rules = None, {}
    if mesh is not None:
        dp = mesh.dp_axes
        n_dp = math.prod(mesh.dp_sizes)
        if b % n_dp:
            raise ValueError(f"global batch {b} must be divisible by the {n_dp} data shards of "
                             f"mesh {mesh.shape}")
        client = compat.flat_axis_index(mesh, dp)
        sharding.check_model_axis(cfg, mesh.model_size)
        pspecs = sharding.lm_pspecs(cfg, mesh)
        rules = sharding.activation_rules(mesh, manual_data=True)
    else:
        dp, n_dp, client = (), 1, 0
    if ts.error_feedback and mesh is None:
        raise ValueError("error_feedback needs data-parallel mesh axes (the sync path)")
    adaptive = ts.adaptive is not None
    if adaptive and mesh is None:
        raise ValueError("adaptive telemetry needs data-parallel mesh axes (the sync path)")
    streamed = ts.streamed and not cfg.enc_dec
    syncs = []   # built from params_like, or from the first call's params

    def sync_for(params):
        if not syncs:
            like = _leaf_list(params_like if params_like is not None else params)
            syncs.append(make_sync_fn(ts, mesh, like))
        return syncs[0]

    def _step(params, opt_state, ef_state, tstate, batch_g, step):
        split_batch, axes = _client_batch(batch_g, n_dp)
        with sharding.axis_rules(mesh, rules):
            loss, grads = _loss_and_grads(cfg, params, client_row(split_batch, axes, client),
                                          streamed)
        g_leaves = [g.to(torch.float32) for g in tree_leaves(grads)]
        key = prng.fold_in(prng.key(_KEY_SEED), step)
        new_ef, new_t, gnorm, cmetrics, live = ef_state, tstate, None, None, None
        if mesh is not None:
            args = [g_leaves, key]
            if ts.elastic is not None:
                live = live_mask(ts.elastic, step, n_dp, loss.device)
                args.append(live)
            if ts.error_feedback:
                args.append(ef_state)
            if adaptive:
                args.append(tstate)
            res = sync_for(params)(*args)
            res = list(res) if isinstance(res, tuple) else [res]
            g_mean = res.pop(0)
            if ts.error_feedback:
                new_ef = res.pop(0)
            if adaptive:
                new_t = res.pop(0)
            if ts.metrics_gnorm:
                gnorm = res.pop(0)
            if ts.metrics_compression:
                mine = res.pop(0)
                cmetrics = type(mine)(*(compat.all_gather_stacked(f, mesh, dp) for f in mine))
            loss = compat.psum(loss, mesh, dp) * (1.0 / n_dp)
        else:
            g_mean = g_leaves
        if ts.metrics_gnorm and gnorm is None:
            gnorm = global_norm(g_mean)
        with record_function("obs.optimizer"):
            new_params, new_opt = opt.update(params, tree_unflatten(params, g_mean), opt_state, step)
        metrics = {"loss": _full(loss, n_dp)}
        if ts.metrics_gnorm:
            metrics["gnorm"] = _full(gnorm, n_dp)
        if cmetrics is not None:
            metrics["compression"] = cmetrics
        if live is not None:
            metrics["live"] = live
            metrics["live_count"] = _full(torch.sum(live), n_dp)
        return new_params, new_opt, new_ef, new_t, metrics

    if ts.error_feedback and adaptive:
        def step_fn(params, opt_state, ef_state, tstate, batch_g, step):
            return _step(params, opt_state, ef_state, tstate, batch_g, step)
    elif ts.error_feedback:
        def step_fn(params, opt_state, ef_state, batch_g, step):
            p, o, e, _, m = _step(params, opt_state, ef_state, None, batch_g, step)
            return p, o, e, m
    elif adaptive:
        def step_fn(params, opt_state, tstate, batch_g, step):
            p, o, _, t, m = _step(params, opt_state, None, tstate, batch_g, step)
            return p, o, t, m
    else:
        def step_fn(params, opt_state, batch_g, step):
            p, o, _, _, m = _step(params, opt_state, None, None, batch_g, step)
            return p, o, m
    step_fn.pspecs = pspecs
    return step_fn
