"""PowerSGD low-rank gradient compression as a codec — the port of
``repro.core.lowrank``.

A bucket's flat ``m`` elements are viewed as a (rows, cols) matrix ``M``
(zero-padded, ``cols`` the largest power of two ≤ √m) and compressed to
rank-``r`` factors by one warm-started power-iteration step:

    P  = M @ Q_prev          (Q_prev from the bucket's EF-row aux tail,
    P̂  = orth(P)              the fixed-seed Q₀ on a cold start)
    Qn = Mᵀ @ P̂

The wire is the bitcast fp32 pair ``(P̂, Qn)``, ``(rows + cols)·r`` words
whatever the bit width, and the decode is the peer mean of ``P̂ @ Qnᵀ``.
The EF residual ``c − P̂ @ Qnᵀ`` (against this peer's own factors) feeds
the next step's error feedback, and ``Qn`` rides in the same EF row
(``state_extra`` = cols·r) to warm-start the next step's iteration.

The orthogonalization is kernel K11 on the card (``kernels.ops``), the
port of the Pallas ``repro.kernels.orthogonalize.orthogonalize_2d``: at
smallnet's (809, 4) factor its 26 KB take nanoseconds to move, and what
bounds it is the chain of 13 dependent block-wide reductions, so it
holds the factor in registers and each reduction costs one shuffle tree
and one barrier (``csrc/orthogonalize.cu``).  The three products are
plain large matrix products, ``torch.matmul`` as the JAX package leaves
them to XLA.  Not chunkable: factor matrices do not slice element-wise,
so the two-phase sync decodes every peer's full wire in phase 1.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ops

from . import prng
from .codecs import Codec, register_codec
from .compressors import CompressorConfig

# Fixed cold-start key: every peer draws the same Q₀ without communication,
# so the peers' factors share one subspace and average.
_Q0_SEED = 0x51D


def matrix_shape(m: int) -> tuple[int, int]:
    """(rows, cols) factorization target of a flat m-element bucket: cols
    is the largest power of two ≤ √m (clamped to [1, m])."""
    if m <= 1:
        return max(m, 1), 1
    cols = 1 << (int(math.isqrt(m)).bit_length() - 1)
    cols = max(min(cols, m), 1)
    return -(-m // cols), cols


def effective_rank(cfg: CompressorConfig, m: int) -> int:
    """``cfg.rank`` clamped to the bucket's matrix: r ≤ min(rows, cols)."""
    rows, cols = matrix_shape(m)
    return max(1, min(cfg.rank, rows, cols))


@functools.lru_cache(maxsize=None)
def _q_init(cols: int, r: int, device: torch.device) -> torch.Tensor:
    """The cold-start Q₀, drawn once per shape and device: a constant, as
    in the JAX trace; never written in place (``torch.where`` and the
    products make new tensors)."""
    # repro: allow REPRO102 (the shared Q0 init is the PowerSGD contract, as in JAX)
    return prng.normal(prng.key(_Q0_SEED), (cols, r), device=device)


def _factorize(cfg: CompressorConfig, flat: torch.Tensor, q_prev=None):
    """One warm-started power-iteration step -> (P̂, Qn, own reconstruction)."""
    m = flat.numel()
    rows, cols = matrix_shape(m)
    r = effective_rank(cfg, m)
    mat = torch.zeros(rows * cols, dtype=torch.float32, device=flat.device)
    mat[:m] = flat
    mat = mat.reshape(rows, cols)
    q = _q_init(cols, r, flat.device)
    if q_prev is not None:
        qm = q_prev.reshape(cols, r)
        # a zero aux (a fresh EF row) means no warm start yet; decided on
        # the device, without a host sync
        q = torch.where(torch.sum(qm * qm) > 0.0, qm, q)
    p_hat = ops.orthogonalize(mat @ q)   # K11 on the card
    q_new = mat.T @ p_hat
    own = (p_hat @ q_new.T).reshape(-1)[:m]
    return p_hat, q_new, own


def _wire(p_hat: torch.Tensor, q_new: torch.Tensor) -> torch.Tensor:
    return torch.cat([p_hat.reshape(-1), q_new.reshape(-1)]).view(torch.int32)


class PowerSGDCodec(Codec):
    """Rank-based low-rank codec; its fidelity knob is ``cfg.rank``."""

    name = "powersgd"
    chunkable = False
    rank_based = True

    def wire_words(self, cfg, n):
        rows, cols = matrix_shape(n)
        return (rows + cols) * effective_rank(cfg, n)

    def state_extra(self, cfg, n):
        _, cols = matrix_shape(n)
        return cols * effective_rank(cfg, n)

    def encode_residual(self, cfg, flat, pln, key, aux=None):
        p_hat, q_new, own = _factorize(cfg, flat, q_prev=aux)
        return _wire(p_hat, q_new), flat - own, q_new.reshape(-1)

    def _peer_recons(self, cfg, rows, n):
        rws, cols = matrix_shape(n)
        r = effective_rank(cfg, n)
        pw = rws * r
        vals = rows.contiguous().view(torch.float32)
        out = []
        for j in range(rows.shape[0]):
            p_hat = vals[j, :pw].reshape(rws, r)
            q_new = vals[j, pw:pw + cols * r].reshape(cols, r)
            out.append((p_hat @ q_new.T).reshape(-1)[:n])
        return out

    def decode_reduce(self, cfg, rows, n):
        recons = self._peer_recons(cfg, rows, n)
        acc = recons[0]
        for v in recons[1:]:
            acc = acc + v
        # a device divisor, filled on the device: CUDA's division by a
        # Python scalar multiplies by its reciprocal, not the IEEE quotient
        return acc / acc.new_full((), len(recons))

    def decode_rows(self, cfg, rows, n):
        return torch.stack(self._peer_recons(cfg, rows, n))


register_codec(PowerSGDCodec())
