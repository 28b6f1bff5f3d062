"""Momentum SGD over the nested param dicts (the paper's optimizer:
lr 0.01, momentum 0.9, weight decay 5e-4).  AdamW for the LM zoo is still
to port (ROADMAP Queue 1 item 1)."""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    # update(params, grads, state) -> (new_params, new_state)


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def momentum_sgd(lr: float = 0.01, momentum: float = 0.9, weight_decay: float = 5e-4) -> Optimizer:
    """Weight decay applies to leaves with ndim > 1 (weights, not biases)."""

    def init(params):
        return _map(torch.zeros_like, params)

    def update(params, grads, state):
        def one(p, g, m):
            g32 = g.to(torch.float32)
            if weight_decay and p.dim() > 1:
                g32 = g32 + weight_decay * p.to(torch.float32)
            m_new = momentum * m + g32
            return p - lr * m_new, m_new

        out = _map(lambda p, g, m: one(p, g, m), params, grads, state)
        pick = lambda i: _map(lambda t: t[i], out)  # noqa: E731
        return pick(0), pick(1)

    return Optimizer(init=init, update=update)
