"""Abstract (allocation-free) model, input and cache specs for the dry run
— the port of ``repro.launch.specs``.

Everything here lives on PyTorch's ``meta`` device, the counterpart of
``jax.eval_shape``: tensors with shapes and dtypes and no storage, so the
full-size configs (up to 398 B parameters) are never materialized.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import prng
from repro_torch.data.synthetic import lm_batch
from repro_torch.dist import sharding
from repro_torch.models import transformer
from repro_torch.models.smallnet import tree_leaves

META = "meta"


def abstract_init(cfg: ArchConfig) -> dict:
    """The params tree of ``init_lm`` on the meta device.  JAX's version
    also returns the logical-axes tree: the port's is
    ``transformer.logical_axes(cfg)``."""
    # repro: allow REPRO204 (a meta draw has no values: the key shapes nothing)
    return transformer.init_lm(prng.key(0), cfg, device=META)


def abstract_batch(cfg: ArchConfig, batch: int, seq: int) -> transformer.Batch:
    """A :class:`~repro_torch.models.transformer.Batch` of meta tensors with
    ``data.synthetic.lm_batch``'s shapes and dtypes."""
    return lm_batch(cfg, 0, batch, seq, META)


def abstract_caches(cfg: ArchConfig, batch: int, cache_len: int):
    return transformer.init_caches(cfg, batch, cache_len, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """All model inputs for a given input shape, as meta tensors.

    train/prefill: {'batch': Batch}.  decode: {'token', 'caches',
    'position'}: the position is a host int in the port (JAX's is an int32
    scalar)."""
    if shape.kind in ("train", "prefill"):
        return {"batch": abstract_batch(cfg, shape.global_batch, shape.seq_len)}
    return {"token": torch.zeros((shape.global_batch, 1), dtype=torch.int64, device=META),
            "caches": abstract_caches(cfg, shape.global_batch, shape.seq_len),
            "position": shape.seq_len - 1}


def count_params(params_like) -> int:
    return sum(x.numel() for x in tree_leaves(params_like))


def count_active_params(cfg: ArchConfig, params_like, logical=None) -> int:
    """Active params per token: expert tensors count top_k/E of their size.

    The expert tensors are the leaves whose logical axes
    (``transformer.logical_axes(cfg)``, the default) name ``"expert"``, as
    JAX finds them: an MoE FFN's router and its ``wi``, ``wg`` and ``wo``.
    The result is JAX's count (held for all ten archs by
    ``tests/test_torch_launch.py``)."""
    if logical is None:
        logical = transformer.logical_axes(cfg)
    total = 0
    for x, la in zip(tree_leaves(params_like), sharding.tree_leaves(logical), strict=True):
        n = x.numel()
        if cfg.moe is not None and "expert" in la:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return int(total)
