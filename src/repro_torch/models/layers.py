"""Basic layers: norms, MLPs, initializers.

The port of ``repro.models.layers``.  Params are plain dicts of tensors;
the JAX package's parallel tree of logical axes comes from the ``*_axes``
functions (``models.transformer.logical_axes`` assembles them).  Norms and
activations compute in float32 and cast back to the input's dtype, as the
JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.dist import sharding


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"float32"``, ``"bfloat16"``) as a torch dtype."""
    return getattr(torch, name)


def dense_init(key: torch.Tensor, shape, in_axis_size: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """``normal(key, shape) / sqrt(in_axis_size)`` in float32, then cast."""
    scale = float(np.float32(1.0) / np.sqrt(np.float32(in_axis_size)))
    return (prng.normal(key, shape, device) * scale).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def norm_init(cfg, d: int, device) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


def norm_axes(cfg) -> dict:
    """The logical axes of :func:`norm_init`'s leaves."""
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def mlp_init(key: torch.Tensor, cfg, d: int, f: int, dtype: torch.dtype, device) -> dict:
    """Gated (SwiGLU/GeGLU) or plain MLP depending on cfg.act."""
    ks = prng.split(key, 3)
    if cfg.act in ("silu", "gelu"):
        return {"wi": dense_init(ks[0], (d, f), d, dtype, device),
                "wg": dense_init(ks[1], (d, f), d, dtype, device),
                "wo": dense_init(ks[2], (f, d), f, dtype, device)}
    # gelu_mlp (whisper-style)
    return {"wi": dense_init(ks[0], (d, f), d, dtype, device),
            "wo": dense_init(ks[2], (f, d), f, dtype, device)}


def mlp_axes(cfg) -> dict:
    """The logical axes of :func:`mlp_init`'s leaves."""
    la = {"wi": ("embed_fsdp", "ff"), "wo": ("ff", "embed_fsdp")}
    if cfg.act in ("silu", "gelu"):
        la["wg"] = ("embed_fsdp", "ff")
    return la


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP on x.  Split over the model axis (``wi``/``wg`` by columns,
    ``wo`` by rows: fewer than ``d_ff`` columns here), each rank computes
    its block of the hidden units and the outputs are summed over the
    model group.  The experts' batched weights (3-D) are never split."""
    split = p["wi"].dim() == 2 and p["wi"].shape[-1] != cfg.d_ff
    if split:
        x = sharding.copy_to_model(x)
    h = x @ p["wi"]
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p["wg"])
    elif cfg.act == "gelu":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ p["wo"]
    return sharding.reduce_from_model(y) if split else y
