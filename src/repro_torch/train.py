"""The paper's N-client synced training loop on smallnet, end to end.

``train_synced`` is the port's counterpart of the JAX package's golden
convergence run (``tests/test_golden_convergence.py::_run``): smallnet on
the synthetic shapes task, ``n_clients`` clients with their own batches,
gradients synced each step through the bucketed reference sync
(``dist.reference``), momentum SGD on the synced mean.  On the card every
sync runs the port's CUDA kernels.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.core.codecs import bucket_state_sizes
from repro_torch.core.compressors import CompressorConfig, plan_buckets
from repro_torch.data.synthetic import client_batches, make_templates
from repro_torch.dist.reference import reference_sync, reference_sync_state
from repro_torch.dist.train_step import TrainStepConfig
from repro_torch.models.smallnet import init_smallnet, smallnet_loss, tree_leaves, tree_unflatten
from repro_torch.optim.optimizers import momentum_sgd

_KEY_SEED = 0x5EED


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    return device


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
                 batch: int = 32, device="cuda", dp_sizes: tuple | None = None) -> list[float]:
    """Fixed-seed synced training; returns the per-step mean client loss.

    ``dp_sizes`` lays the clients out as (pods…, data), row-major, for the
    hierarchical sync (default ``(n_clients,)``: one pod).  ``method="powersgd"``
    runs at ``CompressorConfig``'s rank 4, and its EF rows also carry the
    warm-started Q factor (``bucket_state_sizes``).

    Seeds follow the JAX run: ``key(0)`` for the init, ``key(42)`` for the
    class templates and ``fold_in(key(0x5EED), i)`` for step i's sync.  TF32 is
    switched off for the process, because the golden windows were pinned in
    float32, and cuDNN is held to deterministic algorithms: its default
    convolution backward differs in the last bits from run to run, which the
    error-fed sync carries into a different loss history.
    """
    device = resolve_device(device)
    dp_sizes = (n_clients,) if dp_sizes is None else tuple(dp_sizes)
    if math.prod(dp_sizes) != n_clients:
        raise ValueError(f"dp_sizes {dp_sizes} do not multiply to n_clients={n_clients}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ts = TrainStepConfig(sync=sync, error_feedback=error_feedback,
                         compressor=CompressorConfig(method=method, bits=bits))
    templates = make_templates(prng.key(42), device=device)
    params = init_smallnet(prng.key(0), device=device)
    opt = momentum_sgd(lr=0.01, momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
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
        if error_feedback:
            mean, ef, _, _ = reference_sync_state(ts, stacked, dp_sizes, key, ef=ef)
        else:
            mean = reference_sync(ts, stacked, dp_sizes, key)
        params, state = opt.update(params, tree_unflatten(params, mean), state)
        hist.append(float(torch.mean(losses)))
    return hist

