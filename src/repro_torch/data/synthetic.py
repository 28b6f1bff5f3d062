"""Deterministic synthetic 'shapes' classification data (paper §V's MNIST
stand-in): fixed smooth class templates, pixel noise, and a few outlier
samples with 10x noise that keep the gradients heavy-tailed.

The port of the classification half of ``repro.data.synthetic``, drawn
through ``core.prng`` so it replays the JAX package's stream: labels are
bitwise equal, images ulp-close (normal draws and the smoothing sum round
differently).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng


def make_templates(key: torch.Tensor, num_classes: int = 10, hw: int = 28,
                   device="cuda") -> torch.Tensor:
    """Fixed smooth class templates (num_classes, hw, hw): normal noise
    smoothed by a 5x5 box ('same' size), scaled to unit population std."""
    base = prng.normal(key, (num_classes, hw, hw), device)
    box = torch.full((1, 1, 5, 5), 1.0, device=device) / 25.0
    sm = F.conv2d(base[:, None], box, padding=2)[:, 0]
    std = torch.std(sm, dim=(1, 2), keepdim=True, correction=0)
    return sm / torch.clamp_min(std, 1e-6)


def shapes_batch(templates: torch.Tensor, seed: int, batch: int, noise: float = 0.6,
                 outlier_frac: float = 0.02):
    """Returns (images (B, hw, hw, 1), labels (B,)) for step ``seed``."""
    nc = templates.shape[0]
    device = templates.device
    # the dataset is one fixed stream; seed selects the batch
    k_lab, k_noise, k_out = prng.split(prng.fold_in(prng.key(1), seed), 3)
    labels = prng.randint(k_lab, (batch,), 0, nc, device)
    imgs = templates[labels]
    eps = prng.normal(k_noise, imgs.shape, device) * noise
    is_out = prng.uniform(k_out, (batch, 1, 1), device) < outlier_frac
    imgs = imgs + torch.where(is_out, 10.0 * eps, eps)
    return imgs[..., None].to(torch.float32), labels


def client_batches(templates: torch.Tensor, seed: int, n_clients: int, batch: int):
    """Per-client batches for the N-client DSGD experiments."""
    imgs, labels = shapes_batch(templates, seed, n_clients * batch)
    return (imgs.reshape(n_clients, batch, *imgs.shape[1:]),
            labels.reshape(n_clients, batch))
