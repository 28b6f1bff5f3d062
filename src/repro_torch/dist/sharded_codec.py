"""Local halves of the sharded wire codec — the part of
``repro.dist.sharded_codec`` that the per-leaf reference replay reads.

:func:`_plan_encode_rows` is the per-leaf two-phase site: each of a peer's
chunk rows gets its own sort-based plan (``core.compressors.plan``) and its
own key from ``split(key, k)``, and is encoded by the fused encode-pack
(``core.codecs.encode_pack``: kernel K6 or K7 on the card), its uniforms
drawn on the row's own (ceil(m/128), 128) tile, as the JAX package's vmap
over the rows draws them.  The rows are planned one by one: every row's
plan is ``plan`` of that row, bit for bit.

The mesh collectives (``pack_dim``, ``unpack_dim``,
``two_phase_reduce_scatter_sharded`` and the bucketed bodies) come with
the mesh sync on ``torch.distributed`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.codecs import encode_pack
from repro_torch.core.compressors import CompressorConfig, plan
from repro_torch.core.quantizers import QuantMeta


def _plan_encode_rows(cfg: CompressorConfig, rows: torch.Tensor,
                      key: torch.Tensor) -> tuple[torch.Tensor, QuantMeta]:
    """Per-row plan + fused encode-pack: rows (k, m) fp32 -> ((k, words)
    wire words, metas with levels (k, s+1) and alpha (k,))."""
    keys = prng.split(key, rows.shape[0])
    words, metas = [], []
    for r, k in zip(rows, keys):
        meta = plan(cfg, r)
        words.append(encode_pack(cfg, r, meta, k))
        metas.append(meta)
    return torch.stack(words), QuantMeta(levels=torch.stack([m.levels for m in metas]),
                                         alpha=torch.stack([m.alpha for m in metas]))
