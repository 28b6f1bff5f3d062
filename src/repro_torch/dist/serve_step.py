"""Serving: prefill + single-token decode with KV caches.

The port of ``repro.dist.serve_step``.  Prefill reserves
``DECODE_MARGIN`` extra cache slots beyond the prompt so decode steps can
append without reallocating (decode writes at ``cache.length``; rolling
sliding-window caches index by absolute position instead and need no
margin).

Without a mesh the params' device is the serving device.  On a mesh with
a model axis (``dist.compat.Mesh``, every rank calling the same fns) each
rank holds its slice of the params (``dist.sharding.shard_tree`` by
``pspecs``), attends over its own heads, and its KV caches hold its own KV
heads.  JAX's cache specs (:func:`cache_pspecs`) replicate the heads and
leave the resharding to GSPMD: the numbers are the same.  The logits come
back whole on every rank, gathered over the model group before the
caller's argmax.  The batch stays whole on every rank: serving has no data
split of its own in the port (JAX's specs put the batch on the data axes).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer

from . import sharding

DECODE_MARGIN = 64


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def cache_pspecs(cfg, B: int, cache_len: int, mesh):
    """JAX's PartitionSpecs for the stacked cache tree of
    ``transformer.init_caches(cfg, B, cache_len)``: the batch dim (axis 1,
    after the unit axis) over the data axes when they divide it; everything
    else replicated."""
    dp = sharding.data_axes(mesh)
    caches_like = transformer.init_caches(cfg, B, cache_len, device="meta")

    def one(x):
        if dp is None or x.dim() < 2 or x.shape[1] != B or B % _size(mesh, dp):
            return sharding.P(*(None,) * x.dim())
        return sharding.P(None, dp, *(None,) * (x.dim() - 2))

    return _map_caches(one, caches_like)


def _map_caches(fn, tree):
    """``fn`` over a cache tree's tensors (a KV cache's host length kept)."""
    if isinstance(tree, transformer.KVCache):
        return transformer.KVCache(k=fn(tree.k), v=fn(tree.v), length=tree.length)
    if isinstance(tree, sharding.PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_caches(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):   # an SSMState, or the cross-attention (k, v)
        out = [_map_caches(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree)


def make_serve_fns(cfg, T: int, mesh=None):
    """Build ``(prefill_fn, decode_fn)`` for prompts of ``T`` tokens, both
    run under ``torch.inference_mode()``:

    - ``prefill_fn(params, batch) -> (last-token logits (B, vocab), caches)``
    - ``decode_fn(params, token (B, 1), caches, position) -> (logits, caches)``:
      ``position`` is a host int, and the caches are written in place
      (``transformer.decode_step``).

    With a ``mesh`` (a ``Mesh`` or ``AbstractMesh``, model axis or not;
    every rank calls both fns in the same order) ``params`` are this rank's
    slices and the params' PartitionSpec tree comes third:
    ``(prefill_fn, decode_fn, pspecs)``.  The caches' are JAX's
    ``cspecs``: :func:`cache_pspecs` of ``(cfg, B, T + DECODE_MARGIN,
    mesh)`` (``T`` with a sliding window)."""
    capacity = T if cfg.sliding_window else T + DECODE_MARGIN
    if mesh is None:
        def prefill_fn(params, batch_in):
            with torch.inference_mode():
                return transformer.prefill(cfg, params, batch_in, capacity=capacity)

        def decode_fn(params, token, caches, position: int):
            with torch.inference_mode():
                return transformer.decode_step(cfg, params, token, caches, position)

        return prefill_fn, decode_fn

    sharding.check_model_axis(cfg, mesh.model_size)
    rules = sharding.activation_rules(mesh, fsdp=cfg.fsdp)
    pspecs = sharding.lm_pspecs(cfg, mesh)

    def prefill_fn(params, batch_in):
        with torch.inference_mode(), sharding.axis_rules(mesh, rules):
            return transformer.prefill(cfg, params, batch_in, capacity=capacity)

    def decode_fn(params, token, caches, position: int):
        with torch.inference_mode(), sharding.axis_rules(mesh, rules):
            return transformer.decode_step(cfg, params, token, caches, position)

    return prefill_fn, decode_fn, pspecs
