"""Optimizers over the nested param dicts — the port of
``repro.optim.optimizers``.

The paper trains with momentum SGD (lr 0.01, momentum 0.9, weight decay
5e-4); AdamW is provided for the LM zoo.  State trees mirror the param
tree.  Both follow the JAX package op for op: the update math runs in
float32 whatever the param dtype, and each new param and state leaf is
cast back to the dtype of the leaf it replaces.  Weight decay applies to
leaves with ndim > 1 (weights, not biases or norm scales).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(params, grads, state, step) -> (new_params, new_state)


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _pick(out, i: int):
    return _map(lambda t: t[i], out)


def momentum_sgd(lr: float = 0.01, momentum: float = 0.9, weight_decay: float = 5e-4) -> Optimizer:
    def init(params):
        return _map(torch.zeros_like, params)

    def update(params, grads, state, step):
        del step

        def one(p, g, m):
            g32 = g.to(torch.float32)
            if weight_decay and p.dim() > 1:
                g32 = g32 + weight_decay * p.to(torch.float32)
            m_new = momentum * m.to(torch.float32) + g32
            p_new = p.to(torch.float32) - lr * m_new
            return p_new.to(p.dtype), m_new.to(m.dtype)

        out = _map(one, params, grads, state)
        return _pick(out, 0), _pick(out, 1)

    return Optimizer(init=init, update=update)


class AdamWState(NamedTuple):
    m: Any
    v: Any


def _first_leaf(tree) -> torch.Tensor:
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """Bias correction at ``t = step + 1``: ``c = 1 - b**t`` in float32,
    each a 0-dim tensor on the params' device, so the updates divide by it
    (a Python-float divisor would be multiplied by its reciprocal on the
    card).  ``b**t`` is torch's float32 ``pow``, which XLA's rounds
    differently at some t (ROADMAP fact F15)."""

    def init(params):
        return AdamWState(m=_map(torch.zeros_like, params), v=_map(torch.zeros_like, params))

    def update(params, grads, state, step):
        device = _first_leaf(params).device
        t = torch.as_tensor(step, device=device).to(torch.float32) + 1.0
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=device), t)

        def one(p, g, m, v):
            g32 = g.to(torch.float32)
            m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
            v_new = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p32 = p.to(torch.float32)
            if weight_decay and p.dim() > 1:
                upd = upd + weight_decay * p32
            p_new = p32 - lr * upd
            return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        out = _map(one, params, grads, state.m, state.v)
        return _pick(out, 0), AdamWState(m=_pick(out, 1), v=_pick(out, 2))

    return Optimizer(init=init, update=update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "momentum_sgd":
        return momentum_sgd(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
