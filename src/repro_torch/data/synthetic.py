"""Deterministic synthetic data pipelines, drawn through ``core.prng`` so
they replay the JAX package's streams (``repro.data.synthetic``):

- ``lm_batch``: token streams for the LM zoo (Zipf-ish marginals), plus the
  modality extras each family needs (patch embeddings and M-RoPE positions
  for the VLM, frame embeddings for audio).  Positions are bitwise JAX's;
  a token can move by one at a bin edge, where JAX's affine uniform map
  and cube round differently (``prng.uniform``).
- the 'shapes' classification data (paper §V's MNIST stand-in): fixed
  smooth class templates, pixel noise, and a few outlier samples with 10x
  noise that keep the gradients heavy-tailed.  Labels are bitwise JAX's,
  images ulp-close (normal draws and the smoothing sum round
  differently).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models.transformer import Batch


def _zipf_tokens(key: torch.Tensor, shape, vocab: int, device=None) -> torch.Tensor:
    """Zipf-like marginal over the vocab (heavier head, long tail)."""
    u = prng.uniform(key, shape, device, minval=1e-6, maxval=1.0)
    r = torch.pow(u, 3.0)  # skew toward 0
    return torch.clamp((r * vocab).to(torch.int32), 0, vocab - 1).to(torch.int64)


def make_mrope_positions(batch: int, seq: int, n_patches: int, grid: int = 16,
                         device=None) -> torch.Tensor:
    """(3, B, S) positions: image patches get (t=0, h, w); text continues."""
    idx = torch.arange(n_patches, device=device)
    hh, ww = idx // grid, idx % grid
    text_start = max((n_patches - 1) // grid, (n_patches - 1) % grid) + 1
    t_text = text_start + torch.arange(seq - n_patches, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), t_text]),
                       torch.cat([hh, t_text]),
                       torch.cat([ww, t_text])])                      # (3, S)
    return pos[:, None, :].expand(3, batch, seq)


def lm_batch(cfg, seed: int, batch: int, seq: int, device="cuda") -> Batch:
    """One batch of step ``seed`` for any zoo config."""
    # the dataset is one fixed stream; seed selects the batch
    # repro: allow REPRO204 (the dataset IS the fixed stream; seed selects the batch)
    k_tok, k_extra = prng.split(prng.fold_in(prng.key(0), seed))
    tokens = _zipf_tokens(k_tok, (batch, seq), cfg.vocab, device)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    positions = patches = frames = None
    if cfg.vlm_patches:
        patches = prng.normal(k_extra, (batch, cfg.vlm_patches, cfg.vlm_vision_dim), device)
        positions = make_mrope_positions(batch, seq, cfg.vlm_patches, device=device)
        labels[:, :cfg.vlm_patches] = -1
    if cfg.enc_dec:
        frames = prng.normal(k_extra, (batch, cfg.enc_seq, cfg.d_model), device)
    return Batch(tokens=tokens, labels=labels, positions=positions, patches=patches,
                 frames=frames)


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
    # repro: allow REPRO204 (the dataset IS the fixed stream; seed selects the batch)
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
