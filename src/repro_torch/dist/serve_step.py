"""Serving: prefill + single-token decode with KV caches, on one device.

The port of ``repro.dist.serve_step``.  Prefill reserves
``DECODE_MARGIN`` extra cache slots beyond the prompt so decode steps can
append without reallocating (decode writes at ``cache.length``; rolling
sliding-window caches index by absolute position instead and need no
margin).

The JAX package's version also takes a mesh and returns PartitionSpec trees
for params and caches (``cache_pspecs``); those come with the port's
sharding rules.  Here the params' device is the serving device.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer

DECODE_MARGIN = 64


def make_serve_fns(cfg, T: int):
    """Build ``(prefill_fn, decode_fn)`` for prompts of ``T`` tokens, both
    run under ``torch.inference_mode()``:

    - ``prefill_fn(params, batch) -> (last-token logits (B, vocab), caches)``
    - ``decode_fn(params, token (B, 1), caches, position) -> (logits, caches)``:
      ``position`` is a host int, and the caches are written in place
      (``transformer.decode_step``).

    The JAX package's ``B`` (the batch, for the caches' PartitionSpecs)
    comes back with the sharding rules.
    """
    capacity = T if cfg.sliding_window else T + DECODE_MARGIN

    def prefill_fn(params, batch_in):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch_in, capacity=capacity)

    def decode_fn(params, token, caches, position: int):
        with torch.inference_mode():
            return transformer.decode_step(cfg, params, token, caches, position)

    return prefill_fn, decode_fn
