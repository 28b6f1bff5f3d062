"""Per-bucket compression metrics of the sync — the port of
``repro.obs.metrics``.

The paper picks α and the codebook to minimize the predicted quantization
error E_TQ.  This module computes, from tensors the bucketed sync already
holds, what it takes to check that model on every step:

- the **realized** per-element quantization MSE of this peer's own encode:
  the fused encode's EF residual is ``corrected − C(corrected)``, so it is
  ``Σ resid² / m``;
- the **predicted** per-element E_TQ of the same plan:
  ``tail_from_histogram`` and ``density_from_histogram`` over the one-pass
  statistics the codec already computed, fed to ``core.theory.e_tq_uniform``
  or ``e_tq_nonuniform``;
- the solved α (the codec's ``plan`` of the same statistics), the clip
  fraction ``mean(|g| > α)``, the incoming EF-residual norm, and the wire
  geometry (bits, rank, wire bytes of one peer's transmission).

:func:`local_sums` gives a peer's ``(B, N_REDUCED)`` sums and the static
geometry; :func:`finalize` normalizes them into a
:class:`CompressionMetrics` of ``(B,)`` leaves (``n_model`` is the number
of model shards the sums were added over: 1 in the replay).

The sums of squares are added in a fixed pairwise tree of float32 adds
(:func:`_tree_sum`), so a card and the CPU give them bit for bit; the JAX
package's ``jnp.sum`` adds in XLA's order, so they agree with it to
rounding.

Semantics (as the JAX package's):

- ``realized_mse`` is the worker-side encode's (the transmission the EF
  state compensates); the two-phase mode's phase-2 re-encode and the
  hierarchical cross-pod exchange are not in it.  A dropped peer's
  residual is its whole corrected bucket.
- Uncompressed syncs (``dsgd``) report ``bits=32``, fp32 wire bytes and
  zeros elsewhere; rank-based codecs (``powersgd``) report their rank and
  the realized and EF terms but no α or prediction, and so does the
  plan-less ``fp16`` tier, at 16 bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import theory
from repro_torch.core.codecs import get_codec
from repro_torch.core.distributions import density_from_histogram, tail_from_histogram
from repro_torch.kernels.stats import bin_edges

#: per-bucket reduced columns: resid_sq, clip_count, ef_sq, alpha, predicted
N_REDUCED = 5

#: methods whose predicted error uses the uniform-codebook E_TQ (Eq. 11);
#: every other scalar quantizer gets the non-uniform form (Eq. 15).
_UNIFORM_PRED = ("qsgd", "tqsgd", "dsgd")


class CompressionMetrics(NamedTuple):
    """Per-bucket compression metrics; every leaf is a ``(B,)`` tensor
    (``(n, B)`` from ``dist.reference.reference_sync_state``, row j peer
    j's own encode)."""

    bits: torch.Tensor           # (B,) int32 — wire bits (32 = uncompressed, 0 = rank-based)
    rank: torch.Tensor           # (B,) int32 — factor rank (0 for scalar quantizers)
    alpha: torch.Tensor          # (B,) f32 — solved truncation threshold
    clip_frac: torch.Tensor      # (B,) f32 — fraction of elements with |g| > α
    ef_norm: torch.Tensor        # (B,) f32 — ‖incoming EF residual‖₂
    wire_bytes: torch.Tensor     # (B,) f32 — accounted bytes of one peer transmission
    realized_mse: torch.Tensor   # (B,) f32 — Σ(corrected − C(corrected))² / m
    predicted_mse: torch.Tensor  # (B,) f32 — per-element E_TQ for the same plan


class MetricStatic(NamedTuple):
    """The static geometry beside the sums (Python int tuples)."""

    bits: tuple[int, ...]
    rank: tuple[int, ...]
    wire_bytes: tuple[int, ...]
    sizes: tuple[int, ...]  # bucket element counts


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a flat float32 tensor, zero-padded to a power of two and
    halved pairwise: the same adds in the same order on every device."""
    n = x.numel()
    if n == 0:
        return x.new_zeros(())
    x = torch.cat([x, x.new_zeros((1 << (n - 1).bit_length()) - n)])
    while x.numel() > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return _tree_sum(x * x)


def local_sums(cfgs: list, buckets: list, stats: list | None, state_rows: list | None,
               ef: list | None, compressed: bool) -> tuple[torch.Tensor, MetricStatic]:
    """Per-bucket metric sums of one peer.

    ``cfgs`` are the buckets' compressor configs, ``buckets`` the
    EF-corrected flat buckets the codec encoded, ``stats`` the matching
    one-pass statistics tuples, ``state_rows`` the EF/state rows the sync
    returned (residual, then any codec aux tail), ``ef`` the incoming
    residual rows.  Returns a ``(B, N_REDUCED)`` float32 tensor of sums
    and the static geometry.
    """
    cols, bits_t, rank_t, wire_t, sizes_t = [], [], [], [], []
    edges = None
    for b, g in enumerate(buckets):
        flat = g.reshape(-1)
        m = flat.numel()
        cfg_b = cfgs[b]
        codec = get_codec(cfg_b.method)
        sizes_t.append(m)
        if not compressed:
            bits_t.append(32)
            rank_t.append(0)
            wire_t.append(4 * m)
        elif codec.rank_based:
            bits_t.append(0)
            rank_t.append(int(cfg_b.rank))
            wire_t.append(int(codec.wire_bytes(cfg_b, m)))
        else:
            bits_t.append(int(codec.fixed_wire_bits or cfg_b.bits))
            rank_t.append(0)
            wire_t.append(int(codec.wire_bytes(cfg_b, m)))
        zero = flat.new_zeros((), dtype=torch.float32)
        resid_sq = zero
        if compressed and state_rows is not None:
            resid_sq = _sum_sq(state_rows[b][:m])
        ef_sq = zero
        if ef is not None and ef[b] is not None:
            ef_sq = _sum_sq(ef[b][:m])
        alpha = clip = pred = zero
        # the plan the encode used, again from the same statistics; the
        # plan-less fp16 tier has no α or E_TQ, like the rank-based codecs
        pln = None
        if compressed and not codec.rank_based and stats is not None:
            pln = codec.plan(cfg_b, flat, stats[b])
        if pln is not None:
            if edges is None:
                edges = bin_edges(flat.device)
            counts, log_sums, g_max = stats[b][0], stats[b][1], stats[b][2]
            alpha = pln.alpha.to(torch.float32)
            clip = torch.sum((torch.abs(flat) > alpha).to(torch.float32))
            tail = tail_from_histogram(counts, log_sums, g_max, edges,
                                       gmin_quantile=cfg_b.gmin_quantile)
            if cfg_b.method in _UNIFORM_PRED:
                pred = theory.e_tq_uniform(tail, alpha, cfg_b.bits)
            else:
                dens = density_from_histogram(counts, edges)
                pred = theory.e_tq_nonuniform(tail, dens, alpha, cfg_b.bits)
            pred = pred.to(torch.float32)
        cols.append(torch.stack([resid_sq, clip, ef_sq, alpha, pred]))
    static = MetricStatic(bits=tuple(bits_t), rank=tuple(rank_t),
                          wire_bytes=tuple(wire_t), sizes=tuple(sizes_t))
    return torch.stack(cols), static


def finalize(sums: torch.Tensor, static: MetricStatic, n_model: int) -> CompressionMetrics:
    """Normalize ``(B, N_REDUCED)`` sums, added over ``n_model`` model
    shards, into metrics (``n_model=1``: one peer's own sums)."""
    resid_sq, clip, ef_sq, alpha, pred = (sums[:, i] for i in range(N_REDUCED))
    dev = sums.device
    m_glob = torch.tensor([m * n_model for m in static.sizes], dtype=torch.float32, device=dev)
    inv_shards = 1.0 / n_model
    return CompressionMetrics(
        bits=torch.tensor(static.bits, dtype=torch.int32, device=dev),
        rank=torch.tensor(static.rank, dtype=torch.int32, device=dev),
        alpha=alpha * inv_shards,
        clip_frac=clip / m_glob,
        ef_norm=torch.sqrt(ef_sq),
        wire_bytes=torch.tensor(static.wire_bytes, dtype=torch.float32, device=dev),
        realized_mse=resid_sq / m_glob,
        predicted_mse=pred * inv_shards,
    )
