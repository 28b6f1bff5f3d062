"""Two-stage quantizer primitives (paper §III), PyTorch port.

``Q_λs[T_α(g)]``: truncation to [-α, α] (Eq. 3), then stochastic rounding
onto a codebook L = {l_0 < ... < l_s} (Eq. 4).  ``s = 2^b - 1`` intervals,
codes in [0, s].

Wire words are int32 tensors holding the uint32 bit patterns of
``repro.core.quantizers.pack_codes``: packing sums the lanes in int64 and
the final cast keeps the low 32 bits; unpacking shifts the int32 words.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import prng

_EPS = 1e-12


def num_levels(bits: int) -> int:
    """s = 2^b - 1 intervals -> s+1 codebook points."""
    return 2**bits - 1


def truncate(g: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """T_alpha[g] (Eq. 3): clamp magnitudes to alpha, keeping sign."""
    return torch.minimum(torch.maximum(g, -alpha), alpha)


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32: ``start·(1 − t) + stop·t`` with
    ``t = iota/(num−1)``, then the exact ``stop`` appended.  (torch's own
    linspace uses a two-sided formula and rounds differently.)"""
    start = torch.as_tensor(start, dtype=torch.float32)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=start.device)
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=start.device) / torch.tensor(
        float(div), device=start.device)
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def uniform_levels(alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """Evenly spaced codebook over [-alpha, alpha] (QSGD / TQSGD)."""
    return linspace(-alpha, alpha, num_levels(bits) + 1)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear, clamped to ``fp[0]``/``fp[-1]``
    outside ``[xp[0], xp[-1]]``.  The gathers are ``torch.take``: indexing
    with a 0-dim index tensor (a scalar x) would read it on the host, a
    device sync on the card."""
    x = torch.as_tensor(x, dtype=torch.float32, device=xp.device)
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1), right=True), 1, xp.shape[0] - 1)
    i = i.reshape(x.shape)
    f0, x0 = torch.take(fp, i - 1), torch.take(xp, i - 1)
    df = torch.take(fp, i) - f0
    dx = torch.take(xp, i) - x0
    delta = x - x0
    dx0 = torch.abs(dx) <= 1.4210855e-14          # np.spacing(float32 eps)
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def levels_from_density(edges: torch.Tensor, lam: torch.Tensor, bits: int) -> torch.Tensor:
    """Codebook from a piecewise-constant density λ on |g| bins (Eq. 18).

    Interval boundaries sit at equal increments of the cumulative density,
    mirrored to [-alpha, alpha]; the endpoints are pinned and the levels
    made strictly increasing.  Returns (s+1,) float32.
    """
    s = num_levels(bits)
    alpha = edges[-1]
    full_edges = torch.cat([-edges.flip(0), edges[1:]])
    full_lam = torch.cat([lam.flip(0), lam])
    widths = full_edges[1:] - full_edges[:-1]
    cum = torch.cat([torch.zeros(1, dtype=lam.dtype, device=lam.device),
                     torch.cumsum(full_lam * widths, 0)])
    total = torch.clamp_min(cum[-1], _EPS)
    targets = linspace(torch.zeros((), device=lam.device), total, s + 1)
    levels = interp(targets, cum, full_edges)
    levels = torch.cat([-alpha.reshape(1), levels[1:-1], alpha.reshape(1)])
    min_step = 2.0 * alpha * 1e-6 / (s + 1)
    ramp = min_step * torch.arange(s + 1, dtype=torch.float32, device=lam.device)
    levels = torch.cummax(levels + ramp, 0).values - ramp
    return levels.to(torch.float32)


class QuantMeta(NamedTuple):
    """Per-tensor quantization metadata shipped alongside the codes."""

    levels: torch.Tensor  # (s+1,) float32 codebook
    alpha: torch.Tensor   # scalar float32 truncation threshold (levels[-1])


def stochastic_encode(g: torch.Tensor, meta: QuantMeta, key: torch.Tensor) -> torch.Tensor:
    """Truncate + stochastically round ``g`` onto ``meta.levels`` (Eq. 4):
    uint8 codes of g's shape, unbiased, ``E[levels[code]] = truncate(g, α)``.

    The interval index is ``searchsorted(levels, gt, right) − 1`` clamped to
    [0, s−1]; the rounding draws ``uniform(key, g.shape)``, one word per
    element of g as it is (not of a padded tile).
    """
    levels = meta.levels
    s = levels.shape[0] - 1
    gt = truncate(g, meta.alpha)
    k = torch.searchsorted(levels, gt.reshape(-1), right=True).reshape(gt.shape) - 1
    k = torch.clamp(k, 0, s - 1)
    lo, hi = levels[k], levels[k + 1]
    pr = (gt - lo) / torch.clamp_min(hi - lo, _EPS)
    up = prng.uniform(key, g.shape, device=g.device) < pr
    return (k + up.to(k.dtype)).to(torch.uint8)


def decode(codes: torch.Tensor, meta: QuantMeta) -> torch.Tensor:
    """Map codes back to codebook values (``levels[code]``)."""
    return meta.levels[codes.to(torch.int64)]


def quantize(g: torch.Tensor, meta: QuantMeta, key: torch.Tensor) -> torch.Tensor:
    """encode+decode in one step: the quantized surrogate of ``g``."""
    return decode(stochastic_encode(g, meta, key), meta)


def packed_size(n: int, bits: int) -> int:
    """Number of uint32 words for n codes at ``bits`` bits each."""
    return (n + 31) // 32 * bits


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack flat codes (values < 2^bits) into int32 wire words.

    Layout: group g, bit-plane j -> word[g·bits + j] holds bit j of codes
    [32g .. 32g+31], lane l in bit l.  Shape: (ceil(n/32)·bits,).
    """
    n = codes.shape[0]
    groups = (n + 31) // 32
    padded = torch.zeros(groups * 32, dtype=torch.int64, device=codes.device)
    padded[:n] = codes.to(torch.int64)
    padded = padded.reshape(groups, 32)
    lane = torch.arange(32, dtype=torch.int64, device=codes.device).reshape(1, 32)
    planes = [((padded >> j) & 1).bitwise_left_shift_(lane).sum(1) for j in range(bits)]
    return _to_int32(torch.stack(planes, 1).reshape(-1))                # (groups·bits,)


def unpack_codes(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns (n,) uint8 codes."""
    groups = words.shape[0] // bits
    w = words.to(torch.int32).reshape(groups, bits, 1)
    lane = torch.arange(32, dtype=torch.int32, device=words.device).reshape(1, 32)
    codes = torch.zeros((groups, 32), dtype=torch.uint8, device=words.device)
    for j in range(bits):
        codes |= ((w[:, j] >> lane) & 1).to(torch.uint8) << j
    return codes.reshape(-1)[:n]
