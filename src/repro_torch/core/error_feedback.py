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
from .compressors import CompressorConfig, compress_decompress_leaves


def init_error(leaves: list) -> list:
    """Zero EF state, one fp32 tensor of each leaf's shape."""
    return [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in leaves]


def compress_with_feedback(cfg: CompressorConfig, grads: list, error: list,
                           key: torch.Tensor) -> tuple[list, list]:
    """Returns (compressed leaves to transmit, new error state); leaf i is
    compressed with key ``split(key, n_leaves)[i]``."""
    keys = prng.split(key, len(grads))
    corrected = [g.to(torch.float32) + e for g, e in zip(grads, error)]
    cs = compress_decompress_leaves([cfg] * len(grads), corrected, keys)
    return ([c.to(g.dtype) for c, g in zip(cs, grads)],
            [x - c.to(torch.float32) for x, c in zip(corrected, cs)])
