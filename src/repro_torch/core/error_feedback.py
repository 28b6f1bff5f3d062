"""Error feedback (EF) on top of the per-tensor quantizers, the PyTorch
port of ``repro.core.error_feedback``:

    c_t = C(g_t + e_t);   e_{t+1} = g_t + e_t − c_t

which compensates the truncation bias while keeping the wire format.  A
gradient "tree" here is a list of leaves in ``models.smallnet.tree_leaves``
order, and the error state one fp32 tensor per leaf.
"""
from __future__ import annotations

import torch

from . import prng
from .compressors import CompressorConfig, compress_decompress


def init_error(leaves: list) -> list:
    """Zero EF state, one fp32 tensor of each leaf's shape."""
    return [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in leaves]


def compress_with_feedback(cfg: CompressorConfig, grads: list, error: list,
                           key: torch.Tensor) -> tuple[list, list]:
    """Returns (compressed leaves to transmit, new error state); leaf i is
    compressed with key ``split(key, n_leaves)[i]``."""
    keys = prng.split(key, len(grads))
    outs, new_errs = [], []
    for g, e, k in zip(grads, error, keys):
        corrected = g.to(torch.float32) + e
        c = compress_decompress(cfg, corrected, k)
        outs.append(c.to(g.dtype))
        new_errs.append(corrected - c.to(torch.float32))
    return outs, new_errs
