"""Local halves of the sharded wire codec — the part of
``repro.dist.sharded_codec`` that the per-leaf reference replay reads.

:func:`_plan_encode_rows` is the per-leaf two-phase site: each of a peer's
chunk rows gets its own sort-based plan (``core.compressors.plan``) and its
own key from ``split(key, k)``, and is encoded by the fused encode-pack
(``core.codecs.encode_pack``: kernel K6 or K7 on the card), its uniforms
drawn on the row's own (ceil(m/128), 128) tile, as the JAX package's vmap
over the rows draws them.  The rows are planned one by one: every row's
plan is ``plan`` of that row, bit for bit.

:func:`_live_scale`, :func:`_mask_wire` and :func:`_mask_resid` are the
elastic helpers the bucketed bodies and their replay
(``dist.reference``) apply to a live mask (semantics below).

The mesh collectives (``pack_dim``, ``unpack_dim``,
``two_phase_reduce_scatter_sharded``, ``_self_live`` and the bucketed
bodies) come with the mesh sync on ``torch.distributed`` (ROADMAP Queue 1).
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


# Elastic partial participation (``repro_torch.elastic``): each bucketed body
# optionally takes ``live``, a replicated (n,) float32 0/1 mask over the
# collective's peers.  The semantics, identical across modes:
#
# - a dropped peer's encode still runs (the straggler-timeout contract: the
#   codec path is side-effect-free), but its *wire* is zeroed before the
#   collective — a zeroed row decodes to exactly 0.0 for every registered
#   codec (uniform: α=0 ⇒ code·2α/s−α=0; codebook: all-zero levels look up
#   0; low-rank: P=0,Q=0 ⇒ PQᵀ=0; fp16: bits 0 ⇒ 0.0) — so the decode-
#   reduce mean is Σ_live/n and one multiply by ``n / max(n_live, 1)``
#   renormalizes it to the live-peer mean;
# - the dropped peer's EF row keeps the whole corrected bucket
#   (``e ← g + e``, nothing transmitted), so the residual is recovered —
#   not lost — when the peer rejoins;
# - liveness itself is a replicated pure function of ``(seed, step)``
#   (``elastic.schedule.live_mask``) — no mask collective, so the traced
#   collective count per mode is unchanged (REPRO101 budgets hold).
#
# ``live=None`` (the default) skips every masking op: elastic-off graphs
# stay byte-identical to the pre-elastic codec.


def _live_scale(live: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n / max(n_live, 1)`` renormalization of a zero-filled mean."""
    return live.new_full((), float(n)) / torch.clamp_min(torch.sum(live), 1.0)


def _mask_wire(wire: torch.Tensor, self_live) -> torch.Tensor:
    """Zero a dropped peer's wire words (a select on the words; see above)."""
    if self_live is None:
        return wire
    return torch.where(self_live > 0, wire, torch.zeros_like(wire))


def _mask_resid(resid: torch.Tensor, flat: torch.Tensor, self_live) -> torch.Tensor:
    """Dropped peers keep the whole corrected bucket as their EF residual."""
    if self_live is None:
        return resid
    return torch.where(self_live > 0, resid, flat)
