"""The paper's N-client training loops on smallnet, end to end.

``train_synced`` is the port's counterpart of the JAX package's golden
convergence run (``tests/test_golden_convergence.py::_run``): smallnet on
the synthetic shapes task, ``n_clients`` clients with their own batches,
gradients synced each step through the reference sync
(``dist.reference``: bucketed, or per leaf with ``bucket_mb=0``), momentum
SGD on the synced mean.  Given a ``dist.compat.Mesh`` it runs data
parallel instead: every rank of the process group computes its own
client's gradient and syncs it through ``dist.train_step.make_sync_fn``.
On the card every sync runs the port's CUDA kernels.

``lm_replay_step`` is one step of the LM zoo's data-parallel train step
(``dist.train_step.make_train_step``) with every client in this process:
the clients' gradients, the one-device replay of the sync
(``dist.reference.reference_sync_state``) and the same update, which each
rank of a mesh run must match bit for bit.

``train_clients`` is the counterpart of ``benchmarks/common.py::
train_clients``, the paper's §V experiment: each client compresses every
gradient leaf on its own (``core.compressors``, the sort-based per-tensor
plan), the server averages the decoded leaves.  With ``use_pallas`` the
per-tensor encodes run kernels K12 (uniform methods) or K14 (codebook
methods) on the card.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch

from repro_torch.core import prng
from repro_torch.core.codecs import bucket_state_sizes
from repro_torch.core.compressors import (CompressorConfig, bucket_concat,
                                             compress_decompress_leaves, plan_buckets)
from repro_torch.core.error_feedback import compress_with_feedback, init_error
from repro_torch.data.synthetic import client_batches, make_templates, shapes_batch
from repro_torch.dist import compat
from repro_torch.dist import train_step as tsmod
from repro_torch.dist.reference import reference_sync, reference_sync_state
from repro_torch.dist.train_step import TrainStepConfig, init_ef_state, make_sync_fn
from repro_torch.elastic.schedule import ElasticConfig, live_mask
from repro_torch.models.smallnet import (accuracy, init_smallnet, smallnet_loss, tree_leaves,
                                         tree_unflatten)
from repro_torch.optim.optimizers import momentum_sgd

_KEY_SEED = 0x5EED


def resolve_device(device, mesh: compat.Mesh | None = None) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card raises.

    On a mesh, ``"cuda"`` with no index is the card of the rank's local
    rank (``LOCAL_RANK``, else its rank) modulo the cards: one card holds
    every rank, a host with a card per rank gives each its own.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    if mesh is not None and device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", mesh.rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def _float32_and_deterministic() -> None:
    """Switch TF32 off for the process (the JAX runs are float32) and hold
    cuDNN to deterministic algorithms: its default convolution backward
    differs in the last bits from run to run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _mean(xs: list) -> torch.Tensor:
    """``sum(xs) / len(xs)``: added in order, then one IEEE division."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc / acc.new_full((), len(xs))


def client_grads(params: dict, imgs: torch.Tensor, labels: torch.Tensor):
    """Per-client losses (n,) and gradient leaves stacked (n, *leaf_shape),
    in ``jax.tree.leaves`` order."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    losses, grads = [], []
    for im, lb in zip(imgs, labels):
        loss = smallnet_loss(tree, im, lb)
        grads.append(torch.autograd.grad(loss, leaves))
        losses.append(loss.detach())
    stacked = [torch.stack([g[j] for g in grads]) for j in range(len(leaves))]
    return torch.stack(losses), stacked


def train_synced(sync: str = "faithful", method: str = "tnqsgd", bits: int = 3,
                 error_feedback: bool = False, steps: int = 30, n_clients: int = 8,
                 batch: int = 32, device="cuda", dp_sizes: tuple | None = None,
                 bucket_mb: float = 4.0, elastic: ElasticConfig | None = None,
                 mesh: compat.Mesh | None = None) -> list[float]:
    """Fixed-seed synced training; returns the per-step mean client loss.

    ``dp_sizes`` lays the clients out as (pods…, data), row-major, for the
    hierarchical sync (default ``(n_clients,)``: one pod).  ``method="powersgd"``
    runs at ``CompressorConfig``'s rank 4, and its EF rows also carry the
    warm-started Q factor (``bucket_state_sizes``).  ``bucket_mb`` is
    ``TrainStepConfig``'s: 0 syncs every leaf on its own (the per-leaf
    codec, no error feedback).  ``elastic`` drops peers by its schedule:
    step i syncs under ``live_mask(elastic, i, n_clients)``, as the JAX
    package's golden dropout run does.

    ``mesh`` (a :class:`~repro_torch.dist.compat.Mesh` of ``n_clients``
    ranks; ``dp_sizes`` then defaults to its sizes and must equal them):
    this process is the client of the rank's index, computes only its own
    batch and gradient, and syncs through ``make_sync_fn``; the step's
    live mask is computed on every rank from ``(seed, step)``.  The
    clients' losses are all-gathered once a step, outside the sync, so
    every rank returns the same history, bitwise the one-device run's
    where the gradients agree bitwise.  The caller initializes the process
    group.

    Seeds follow the JAX run: ``key(0)`` for the init, ``key(42)`` for the
    class templates and ``fold_in(key(0x5EED), i)`` for step i's sync.  TF32 is
    switched off for the process, because the golden windows were pinned in
    float32, and cuDNN is held to deterministic algorithms: its default
    convolution backward differs in the last bits from run to run, which the
    error-fed sync carries into a different loss history.
    """
    device = resolve_device(device, mesh)
    if mesh is not None:
        if dp_sizes is not None and tuple(dp_sizes) != mesh.dp_sizes:
            raise ValueError(f"dp_sizes {tuple(dp_sizes)} are not the mesh's {mesh.dp_sizes}")
        dp_sizes = mesh.dp_sizes
    dp_sizes = (n_clients,) if dp_sizes is None else tuple(dp_sizes)
    if math.prod(dp_sizes) != n_clients:
        raise ValueError(f"dp_sizes {dp_sizes} do not multiply to n_clients={n_clients}")
    _float32_and_deterministic()
    ts = TrainStepConfig(sync=sync, error_feedback=error_feedback, bucket_mb=bucket_mb,
                         elastic=elastic, compressor=CompressorConfig(method=method, bits=bits),
                         metrics_gnorm=False)
    # repro: allow REPRO204 (the paper's setting: the golden runs' fixed streams)
    templates = make_templates(prng.key(42), device=device)
    # repro: allow REPRO204 (the paper's setting: the golden runs' fixed streams)
    params = init_smallnet(prng.key(0), device=device)
    opt = momentum_sgd(lr=0.01, momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
    if mesh is not None:
        return _train_mesh(ts, mesh, templates, params, opt, state, steps, n_clients, batch)
    ef = None
    if error_feedback:
        bp = plan_buckets([x.numel() for x in tree_leaves(params)], ts.bucket_elements)
        ef = [torch.zeros((n_clients, s), dtype=torch.float32, device=device)
              for s in bucket_state_sizes(ts.compressor, bp.sizes, ts.bits_plan)]
    hist = []
    for i in range(steps):
        imgs, labels = client_batches(templates, i, n_clients, batch)
        losses, stacked = client_grads(params, imgs, labels)
        key = prng.fold_in(prng.key(_KEY_SEED), i)
        live = None if ts.elastic is None else live_mask(ts.elastic, i, n_clients, device)
        if error_feedback:
            mean, ef, _, _ = reference_sync_state(ts, stacked, dp_sizes, key, ef=ef, live=live)
        else:
            mean = reference_sync(ts, stacked, dp_sizes, key, live=live)
        params, state = opt.update(params, tree_unflatten(params, mean), state, i)
        hist.append(float(torch.mean(losses)))
    return hist


def _train_mesh(ts: TrainStepConfig, mesh: compat.Mesh, templates, params, opt, state,
                steps: int, n_clients: int, batch: int) -> list[float]:
    """:func:`train_synced`'s loop on one rank of ``mesh``."""
    rank = compat.flat_axis_index(mesh, mesh.axis_names)
    leaves = tree_leaves(params)
    sync = make_sync_fn(ts, mesh, leaves)
    ef = init_ef_state(leaves, ts) if ts.error_feedback else None
    hist = []
    for i in range(steps):
        imgs, labels = client_batches(templates, i, n_clients, batch)
        losses, stacked = client_grads(params, imgs[rank:rank + 1], labels[rank:rank + 1])
        args = [[g[0] for g in stacked], prng.fold_in(prng.key(_KEY_SEED), i)]
        if ts.elastic is not None:
            args.append(live_mask(ts.elastic, i, n_clients, imgs.device))
        if ef is not None:
            args.append(ef)
        out = sync(*args)
        if ef is not None:
            mean, ef = out
        else:
            mean = out
        params, state = opt.update(params, tree_unflatten(params, mean), state, i)
        # the clients' losses, gathered once a step outside the sync
        everyone = compat.all_gather_stacked(losses[0], mesh, mesh.axis_names)
        hist.append(float(torch.mean(everyone)))
    return hist


def lm_replay_step(cfg, ts: TrainStepConfig, opt, dp_sizes: tuple, params: dict, opt_state,
                   ef, batch, step: int):
    """One step of :func:`~repro_torch.dist.train_step.make_train_step` on
    the mesh ``dp_sizes`` with every client in this process: each client's
    loss and gradients in client order, ``reference_sync_state`` over the
    stacked float32 gradients under the step key, the update.  ``ef``: the
    stacked (n, m) EF rows, or None.  Returns ``(params, opt_state, ef,
    metrics)``, ``metrics`` the mesh step's: ``loss`` (the clients' losses
    added in order, times the float32 1/n) and ``gnorm`` (of the mean
    buckets), each (n,).  Where every client's gradient is bitwise the
    one its rank computes (fact F10) and the rank count is 2 (so the
    mesh's sum of two losses has one order), every rank of the mesh run
    returns these bits."""
    n = math.prod(dp_sizes)
    split_batch, axes = tsmod._client_batch(batch, n)
    streamed = ts.streamed and not cfg.enc_dec
    losses, grads = [], []
    for c in range(n):
        loss, g = tsmod._loss_and_grads(cfg, params, tsmod.client_row(split_batch, axes, c),
                                        streamed)
        losses.append(loss)
        grads.append([x.to(torch.float32) for x in tree_leaves(g)])
    stacked = [torch.stack([g[j] for g in grads]) for j in range(len(grads[0]))]
    key = prng.fold_in(prng.key(_KEY_SEED), step)
    live = None if ts.elastic is None else live_mask(ts.elastic, step, n, stacked[0].device)
    mean, ef, _, _ = reference_sync_state(ts, stacked, tuple(dp_sizes), key, ef=ef, live=live)
    bp = plan_buckets([x[0].numel() for x in stacked], ts.bucket_elements)
    gnorm = tsmod.global_norm(bucket_concat(mean, bp))
    params, opt_state = opt.update(params, tree_unflatten(params, mean), opt_state, step)
    total = losses[0]
    for x in losses[1:]:
        total = total + x
    metrics = {"loss": tsmod._full(total * (1.0 / n), n), "gnorm": tsmod._full(gnorm, n)}
    return params, opt_state, ef, metrics


def train_clients(method: str, bits: int, *, rounds: int = 80, n_clients: int = 8,
                  batch: int = 32, lr: float = 0.01, momentum: float = 0.9,
                  weight_decay: float = 5e-4, seed: int = 0, eval_batch: int = 2048,
                  error_feedback: bool = False, bits_plan=None, use_pallas: bool = False,
                  device="cuda") -> tuple[float, list[float]]:
    """The paper's §V run: ``n_clients`` clients, momentum SGD, every
    gradient leaf compressed on its own by each client; returns (accuracy
    on ``eval_batch`` held-out samples, per-round mean client loss).

    ``error_feedback`` keeps one EF residual list per client
    (``core.error_feedback``); ``bits_plan`` gives one wire width per leaf
    (``tree_leaves`` order) in place of ``bits``; ``use_pallas`` encodes
    through the K12/K14 kernels (``CompressorConfig.use_pallas``).  Seeds
    follow ``benchmarks/common.py``: ``key(seed)`` for the init, ``key(42)``
    for the templates, ``fold_in(key(7), i·n_clients + c)`` for client c in
    round i, then ``fold_in(·, j)`` for leaf j (``split`` in
    ``compress_with_feedback``), and the evaluation batch is
    ``shapes_batch(templates, 10_000, eval_batch)``.  TF32 and cuDNN are set
    as in :func:`train_synced`.
    """
    device = resolve_device(device)
    _float32_and_deterministic()
    # repro: allow REPRO204 (the JAX run's fixed dataset stream, benchmarks/common.py)
    templates = make_templates(prng.key(42), device=device)
    params = init_smallnet(prng.key(seed), device=device)
    opt = momentum_sgd(lr=lr, momentum=momentum, weight_decay=weight_decay)
    state = opt.init(params)
    ccfg = CompressorConfig(method=method, bits=bits, use_pallas=use_pallas)
    n_leaves = len(tree_leaves(params))
    if bits_plan is not None and len(bits_plan) != n_leaves:
        raise ValueError(f"bits_plan has {len(bits_plan)} entries for {n_leaves} leaves")
    leaf_cfgs = [ccfg if bits_plan is None else dataclasses.replace(ccfg, bits=int(b))
                 for b in (bits_plan if bits_plan is not None else [bits] * n_leaves)]
    errs = [init_error(tree_leaves(params)) for _ in range(n_clients)]
    hist = []
    for i in range(rounds):
        imgs, labels = client_batches(templates, i, n_clients, batch)
        losses, stacked = client_grads(params, imgs, labels)
        grads = []
        for c in range(n_clients):
            g = [leaf[c] for leaf in stacked]
            if method != "dsgd":
                # repro: allow REPRO204 (the JAX run's per-round key stream)
                key = prng.fold_in(prng.key(7), i * n_clients + c)
                if error_feedback and bits_plan is None:
                    g, errs[c] = compress_with_feedback(ccfg, g, errs[c], key)
                else:
                    keys = [prng.fold_in(key, j) for j in range(n_leaves)]
                    if error_feedback:
                        corrected = [x.to(torch.float32) + e for x, e in zip(g, errs[c])]
                        g = compress_decompress_leaves(leaf_cfgs, corrected, keys)
                        errs[c] = [x - y for x, y in zip(corrected, g)]
                    else:
                        g = compress_decompress_leaves(leaf_cfgs, g, keys)
            grads.append(g)
        gmean = [_mean([g[j] for g in grads]) for j in range(n_leaves)]
        params, state = opt.update(params, tree_unflatten(params, gmean), state, i)
        hist.append(float(_mean(list(losses))))
    imgs, labels = shapes_batch(templates, 10_000, eval_batch)
    return float(accuracy(params, imgs, labels)), hist
