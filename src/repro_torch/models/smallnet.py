"""Small conv classifier for the paper's MNIST-style experiments (§V).

The port of ``repro.models.smallnet`` in the JAX package's layout:
parameters are a nested dict with HWIO conv weights, activations are NHWC,
and the leaves go in ``jax.tree.leaves`` order (sorted keys), because the
sync's bucket plan, bucket contents and per-element random draw all follow
that order and each leaf's row-major flattening.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng


def init_smallnet(key: torch.Tensor, num_classes: int = 10, device="cuda") -> dict:
    """He-normal weights and zero biases, drawn from ``key`` as JAX does."""
    k = prng.split(key, 4)

    def he(kk, shape, fan):
        return prng.normal(kk, shape, device) * float(np.sqrt(np.float32(2.0 / fan)))

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    return {
        "conv1": {"w": he(k[0], (3, 3, 1, 16), 9), "b": zeros(16)},
        "conv2": {"w": he(k[1], (3, 3, 16, 32), 144), "b": zeros(32)},
        "fc1": {"w": he(k[2], (7 * 7 * 32, 128), 7 * 7 * 32), "b": zeros(128)},
        "fc2": {"w": he(k[3], (128, num_classes), 128), "b": zeros(num_classes)},
    }


def params_from_jax(tree, device="cuda") -> dict:
    """Nested dict of numpy arrays (a JAX param tree pulled to the host)
    -> the port's param dict of float32 tensors on ``device``."""
    return {name: {leaf: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device)
                   for leaf, v in sub.items()}
            for name, sub in tree.items()}


def tree_leaves(tree: dict) -> list:
    """Leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_unflatten(like: dict, leaves: list) -> dict:
    """Inverse of :func:`tree_leaves` onto the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return build(like)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, NHWC activations and HWIO weights."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1) + b


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def smallnet_logits(params: dict, imgs: torch.Tensor) -> torch.Tensor:
    x = _pool(torch.relu(_conv(imgs, params["conv1"]["w"], params["conv1"]["b"])))
    x = _pool(torch.relu(_conv(x, params["conv2"]["w"], params["conv2"]["b"])))
    x = x.reshape(x.shape[0], -1)      # NHWC flatten, as the fc1 weight expects
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def smallnet_loss(params: dict, imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ll = F.log_softmax(smallnet_logits(params, imgs), dim=-1)
    return -torch.mean(torch.gather(ll, 1, labels.reshape(-1, 1)))


def accuracy(params: dict, imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of ``imgs`` whose largest logit is their label (a float32 scalar)."""
    hits = torch.argmax(smallnet_logits(params, imgs), -1) == labels
    return torch.mean(hits.to(torch.float32))
