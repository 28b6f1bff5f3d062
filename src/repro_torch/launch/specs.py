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
from repro_torch.models import transformer
from repro_torch.models.smallnet import tree_leaves

META = "meta"


def abstract_init(cfg: ArchConfig) -> dict:
    """The params tree of ``init_lm`` on the meta device.  JAX's version
    also returns the logical-axes tree, which the port's ``init_lm`` does
    not build until its sharding rules land (ROADMAP Queue 1, item 4.2)."""
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


def _expert_leaf(cfg: ArchConfig, path: tuple, x) -> bool:
    """A tensor with an experts' axis: an MoE FFN's ``router`` (d, E) and
    its ``wi``, ``wg`` and ``wo`` (E, ·, ·) (``models.moe.moe_init``), each
    stacked on the unit axis.  These are the leaves whose logical axes name
    ``"expert"`` in the JAX package (its router's are ("embed",
    "expert")); attention and SSM weights have none."""
    if cfg.moe is None or len(path) < 2 or path[-2] != "ffn":
        return False
    e = cfg.moe.num_experts
    if path[-1] == "router":
        return x.shape[-1] == e
    return path[-1] in ("wi", "wg", "wo") and x.dim() == 4 and x.shape[1] == e


def _walk(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def count_active_params(cfg: ArchConfig, params_like) -> int:
    """Active params per token: expert tensors count top_k/E of their size.

    The JAX package finds the expert tensors by their logical axes; the
    port's params carry none (ROADMAP Queue 1, item 4.2), so it finds them
    by the rule of :func:`_expert_leaf`: an MoE subtree's router, ``wi``,
    ``wg`` and ``wo``.  The result is JAX's count (held for all
    ten archs by ``tests/test_torch_launch.py``)."""
    total = 0
    for path, x in _walk(params_like):
        n = x.numel()
        if _expert_leaf(cfg, path, x):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return int(total)
