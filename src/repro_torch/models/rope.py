"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

The port of ``repro.models.rope``.  M-RoPE (arXiv:2409.12191): the rotary
dim is split into three sections (temporal, height, width) with independent
position streams; text tokens use identical positions in all three
sections, image patches use (t, h, w).  Position ids are supplied as
(3, B, S) integers; standard RoPE takes (B, S).
"""
from __future__ import annotations

import numpy as np
import torch

# M-RoPE section split as fractions of head_dim/2 (Qwen2-VL uses 16/24/24
# of 64 frequency pairs for head_dim 128).
MROPE_SECTIONS = (0.25, 0.375, 0.375)

_LOG_1E4 = float(np.log(np.float32(10_000.0)).astype(np.float32))


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., head_dim); cos/sin: float32, broadcastable (..., head_dim//2).
    The rotation runs in float32 (a bfloat16 x promotes) and casts back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integers."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    return _apply_rotary(x, torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :])


def mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (3, B, S) integers (t, h, w streams)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    sizes = [int(round(f * half)) for f in MROPE_SECTIONS]
    sizes[-1] = half - sizes[0] - sizes[1]
    # each frequency's position stream, by section
    sec_ids = torch.cat([torch.full((n,), i, dtype=torch.int64, device=x.device)
                         for i, n in enumerate(sizes)])                 # (half,)
    pos_per_freq = positions.float().permute(1, 2, 0)[..., sec_ids]    # (B, S, half)
    ang = pos_per_freq * freqs
    return _apply_rotary(x, torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :])


def _sincos_freqs(half: int, device) -> torch.Tensor:
    return torch.exp(-_LOG_1E4 * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))


def sincos_embedding(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d), float32."""
    freqs = _sincos_freqs(d // 2, device)
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sincos_row(position: int, d: int, device=None) -> torch.Tensor:
    """Row ``position`` of :func:`sincos_embedding` (d,), computed alone."""
    ang = torch.tensor(float(position), dtype=torch.float32, device=device) * _sincos_freqs(d // 2, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def apply_positional(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Dispatch on cfg.rope for q/k tensors."""
    if cfg.rope == "rope":
        return rope(x, positions if positions.ndim == 2 else positions[0], cfg.rope_theta)
    if cfg.rope == "mrope":
        if positions.ndim == 2:  # plain text stream: all three sections equal
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return mrope(x, positions, cfg.rope_theta)
    return x  # sincos/learned handled at the embedding level
