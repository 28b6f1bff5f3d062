"""Plain PyTorch versions of the port's kernels.

Each function takes exactly the operands of its kernel — the padded
(rows, 128) bucket, the true element count n, and the explicit uniform draw
``rand`` where the kernel rounds stochastically — and returns what the
kernel returns.  They are the CPU path of ``kernels.ops`` and the card's
oracle: on the card, ``chip_smoke.py`` and the ``gpu`` tests hold every
kernel against them on identical inputs.

Divisions by a constant divide by a 0-dim tensor on the operand's device:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which is not the IEEE quotient the kernels and the JAX package compute.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quantizers import pack_codes, unpack_codes

from . import stats as S
from .orthogonalize import EPS as GS_EPS


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / x.new_full((), d)


def bucket_stats(g2: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, 128) fp32 bucket, n true elements -> (STATS_ROWS, NUM_BINS)
    statistics tile, walking the Pallas kernel's 64-row tiles and merging their
    partials in tile order (``stats._block_stats`` / ``stats._merge``).

    Counts and max are exact.  Each tile's ln and moment sums are taken in
    float64 and rounded to float32 once, then merged in tile order: a
    float32 sum over a tile whose 8,192 elements share one bin drifts by
    1e-4 of its value, beyond the kernels' rtol.
    """
    flat = g2.reshape(-1).to(torch.float32)
    m = S.BLOCK_ROWS * S.LANES
    blocks = -(-flat.numel() // m)
    x = torch.zeros(blocks * m, dtype=torch.float32, device=flat.device)
    x[:flat.numel()] = flat
    valid = torch.arange(blocks * m, device=flat.device) < n
    vmask = valid.to(torch.float32)
    gabs = torch.abs(x) * vmask
    lnab = torch.log(torch.clamp_min(gabs, 1e-30))
    w = (S.LOG2_HI - S.LOG2_LO) / S.NUM_BINS
    b = torch.floor((_div(lnab, float(math.log(2.0))) - S.LOG2_LO) / w)
    b = torch.clamp(b, 0.0, S.NUM_BINS - 1.0).to(torch.int64)
    # invalid elements go to a spare bin NUM_BINS that is dropped
    b = torch.where(valid, b, S.NUM_BINS)
    slot = torch.arange(blocks, device=flat.device).repeat_interleave(m) * (S.NUM_BINS + 1) + b
    # The float64 below is the exact per-tile sum, rounded to float32 once
    # (the docstring's reason); this plain version runs on the CPU, whose
    # index_add adds in index order.  Neither reaches the card's sync.
    # repro: allow REPRO103 (exact per-tile sums, rounded to float32 once)
    hist = torch.zeros(blocks * (S.NUM_BINS + 1), dtype=torch.float64, device=flat.device)
    # repro: allow REPRO103, REPRO104 (exact per-tile sums; the CPU adds in index order)
    counts = hist.index_add(0, slot, vmask.double()).reshape(blocks, -1)[:, :S.NUM_BINS]
    # repro: allow REPRO103, REPRO104 (exact per-tile sums; the CPU adds in index order)
    logsum = hist.index_add(0, slot, (lnab * vmask).double()).reshape(blocks, -1)[:, :S.NUM_BINS]
    # repro: allow REPRO103 (exact per-tile sums, rounded to float32 once)
    gv = (x * vmask).reshape(blocks, m).double()
    part = torch.zeros((blocks, S.STATS_ROWS, S.NUM_BINS), dtype=torch.float32, device=flat.device)
    # repro: allow REPRO103 (exact per-tile sums, rounded to float32 once)
    part[:, 0], part[:, 1] = counts.float(), logsum.float()
    part[:, 2] = gabs.reshape(blocks, m).amax(1, keepdim=True)
    # repro: allow REPRO103 (exact per-tile sums, rounded to float32 once)
    part[:, 3], part[:, 4] = gv.sum(1, keepdim=True).float(), (gv * gv).sum(1, keepdim=True).float()
    acc = torch.zeros((S.STATS_ROWS, S.NUM_BINS), dtype=torch.float32, device=flat.device)
    for i in range(blocks):
        nxt = acc + part[i]
        nxt[2] = torch.maximum(acc[2], part[i, 2])
        acc = nxt
    return acc


def ef_correct_stats(g2: torch.Tensor, e2: torch.Tensor, n: int):
    """``c = g + e`` plus the statistics tile of c's first n elements."""
    c2 = g2 + e2
    return c2, bucket_stats(c2, n)


def _codebook_select(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor):
    """``quantize.codebook_select``: stochastic rounding of g onto the
    (s+1,) codebook with the explicit uniforms ``rand``.  Returns (int64
    codes in [0, s], ``levels[code]``).

    The interval index comes from a binary search, which equals the
    kernels' compare-count ``#(clip(g) >= levels[1:])`` clamped to [0, s−1]:
    clipping puts every value at or above levels[0].
    """
    s = levels.shape[0] - 1
    alpha = levels[s]
    gt = torch.minimum(torch.maximum(g2, -alpha), alpha)
    k = torch.searchsorted(levels, gt.reshape(-1), right=True).reshape(gt.shape) - 1
    k = torch.clamp(k, 0, s - 1)
    lo, hi = levels[k], levels[k + 1]
    up = rand < (gt - lo) / torch.clamp_min(hi - lo, 1e-12)
    return k + up.to(k.dtype), torch.where(up, hi, lo)


def _uniform_select(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                    s: int) -> torch.Tensor:
    """``quantize.uniform_select`` op for op -> float codes in [0, s]:
    ``scale = s/(2α)``, ``u = (clip(g, −α, α) + α)·scale``,
    ``k = clip(floor u, 0, s−1)``, ``code = clip(k + (rand < u − k), 0, s)``.
    The clamps of k and the code are ``fmin``/``fmax``, which drop a NaN as
    the kernels' ``fminf``/``fmaxf`` do, so α = 0 (an infinite scale) gives
    code 0, as the JAX package's float→int conversion does."""
    alpha = alpha.reshape(())
    zero = torch.zeros((), dtype=torch.float32, device=g2.device)
    scale = (zero + float(s)) / (2.0 * alpha)
    u = (torch.minimum(torch.maximum(g2, -alpha), alpha) + alpha) * scale
    k = torch.fmin(torch.fmax(torch.floor(u), zero), zero + float(s - 1))
    return torch.fmin(torch.fmax(k + (rand < u - k).to(torch.float32), zero), zero + float(s))


def _masked(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Flat int64 codes with every code past element n zeroed (``_mask_tail``)."""
    codes = codes.reshape(-1).to(torch.int64, copy=True)
    codes[n:] = 0
    return codes


def _words(codes: torch.Tensor, rows: int, bits: int) -> torch.Tensor:
    return pack_codes(codes, bits).reshape(rows, -1)


def codebook_encode_pack_residual(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                                  n: int, bits: int):
    """(rows, 128) bucket + (rows, 128) uniforms + (s+1,) codebook ->
    ((rows, 4·bits) int32 wire words, (rows, 128) residual ``g − levels[code]``).
    Codes past n are zero."""
    codes, value = _codebook_select(g2, rand, levels)
    return _words(_masked(codes, n), g2.shape[0], bits), g2 - value


def codebook_encode_pack(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                         n: int, bits: int) -> torch.Tensor:
    """The wire words of :func:`codebook_encode_pack_residual` alone."""
    return codebook_encode_pack_residual(g2, rand, levels, n, bits)[0]


def _step(alpha: torch.Tensor, s: int) -> torch.Tensor:
    """The uniform level gap ``2α/s``, an IEEE quotient as in the kernels."""
    return _div(2.0 * alpha, float(s))


def uniform_encode_pack_residual(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                                 n: int, bits: int):
    """(rows, 128) bucket + (rows, 128) uniforms + (1,) α -> ((rows, 4·bits)
    int32 wire words, (rows, 128) residual ``g − (code·2α/s − α)``).
    Codes past n are zero, and the residual there is taken from the zeroed
    code, as in the Pallas kernel."""
    s = 2**bits - 1
    alpha = alpha.reshape(())
    codes = _masked(_uniform_select(g2, rand, alpha, s), n)
    resid = g2 - (codes.reshape(g2.shape).to(torch.float32) * _step(alpha, s) - alpha)
    return _words(codes, g2.shape[0], bits), resid


def uniform_encode_pack(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                        n: int, bits: int) -> torch.Tensor:
    """The wire words of :func:`uniform_encode_pack_residual` alone."""
    return uniform_encode_pack_residual(g2, rand, alpha, n, bits)[0]


def uniform_encode(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """K12: (rows, 128) g + uniforms + (1,) α -> (rows, 128) int32 codes,
    the padding past n encoded too (no mask)."""
    return _uniform_select(g2, rand, alpha, 2**bits - 1).to(torch.int32)


def codebook_encode(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """K14: (rows, 128) g + uniforms + (s+1,) codebook -> (rows, 128) int32
    codes, the padding past n encoded too."""
    return _codebook_select(g2, rand, levels)[0].to(torch.int32)


def codebook_encode_segments(g2s: list, rands: list, levels: list) -> torch.Tensor:
    """Segmented K14: :func:`codebook_encode` on each (rows_i, 128) tile with
    its own uniforms and codebook, the codes stacked into (Σ rows_i, 128)."""
    return torch.cat([codebook_encode(g2, rand, lv) for g2, rand, lv in zip(g2s, rands, levels)])


def uniform_encode_segments(g2s: list, rands: list, alphas: list, bits: list) -> torch.Tensor:
    """Segmented K12: :func:`uniform_encode` on each (rows_i, 128) tile with
    its own uniforms, α and bits, the codes stacked into (Σ rows_i, 128)."""
    return torch.cat([uniform_encode(g2, rand, a, b)
                      for g2, rand, a, b in zip(g2s, rands, alphas, bits)])


def uniform_encode_pack_codes(g2: torch.Tensor, rand: torch.Tensor, alpha: torch.Tensor,
                              n: int, bits: int):
    """K16: K12's codes zeroed past n, and their words: ((rows, 128) int32
    codes, (rows, 4·bits) int32 words)."""
    codes = _masked(_uniform_select(g2, rand, alpha, 2**bits - 1), n)
    return codes.to(torch.int32).reshape(g2.shape), _words(codes, g2.shape[0], bits)


def codebook_encode_pack_codes(g2: torch.Tensor, rand: torch.Tensor, levels: torch.Tensor,
                               n: int, bits: int):
    """K17: K14's codes zeroed past n, and their words."""
    codes = _masked(_codebook_select(g2, rand, levels)[0], n)
    return codes.to(torch.int32).reshape(g2.shape), _words(codes, g2.shape[0], bits)


def uniform_decode(codes2: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """K13: (rows, 128) int32 codes + (1,) α -> ``code·((2α)/s) − α``, the
    product and the difference rounded apart."""
    alpha = alpha.reshape(())
    return codes2.to(torch.float32) * _step(alpha, 2**bits - 1) - alpha


def codebook_decode(codes2: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """K15: (rows, 128) int32 codes + (s+1,) codebook -> ``levels[code]``;
    a code outside [0, s] gives 0, as the Pallas kernel's one-hot product."""
    s = levels.shape[0] - 1
    inside = (codes2 >= 0) & (codes2 <= s)
    return torch.where(inside, levels[torch.clamp(codes2, 0, s).to(torch.int64)],
                       torch.zeros((), dtype=torch.float32, device=codes2.device))


def _peer_codes(words3: torch.Tensor, p: int, bits: int) -> torch.Tensor:
    rows = words3.shape[1]
    return unpack_codes(words3[p].reshape(-1), rows * S.LANES, bits).to(torch.int64)


def _codebook_vals(words3, levels2, p: int, bits: int) -> torch.Tensor:
    return levels2[p][_peer_codes(words3, p, bits)]


def _uniform_vals(words3, alphas, p: int, bits: int) -> torch.Tensor:
    a = alphas[p]
    return _peer_codes(words3, p, bits).to(torch.float32) * _step(a, 2**bits - 1) - a


def _reduce(vals, words3, meta, bits: int) -> torch.Tensor:
    """The peers added in order, then divided once by their count."""
    peers, rows, _ = words3.shape
    acc = torch.zeros(rows * S.LANES, dtype=torch.float32, device=words3.device)
    for p in range(peers):
        acc = acc + vals(words3, meta, p, bits)
    return _div(acc, float(peers)).reshape(rows, S.LANES)


def _rows(vals, words3, meta, bits: int) -> torch.Tensor:
    peers, rows, _ = words3.shape
    return torch.stack([vals(words3, meta, p, bits) for p in range(peers)]).reshape(
        peers, rows, S.LANES)


def codebook_decode_reduce(words3: torch.Tensor, levels2: torch.Tensor, bits: int) -> torch.Tensor:
    """(peers, rows, 4·bits) wire words + (peers, s+1) codebooks ->
    (rows, 128) mean over peers of ``levels_p[code]``."""
    return _reduce(_codebook_vals, words3, levels2, bits)


def uniform_decode_reduce(words3: torch.Tensor, alphas: torch.Tensor, bits: int) -> torch.Tensor:
    """(peers, rows, 4·bits) wire words + (peers,) α -> (rows, 128) mean over
    peers of ``code·2α_p/s − α_p``."""
    return _reduce(_uniform_vals, words3, alphas, bits)


def codebook_decode_rows(words3: torch.Tensor, levels2: torch.Tensor, bits: int) -> torch.Tensor:
    """(peers, rows, 4·bits) + (peers, s+1) -> (peers, rows, 128) ``levels_p[code]``."""
    return _rows(_codebook_vals, words3, levels2, bits)


def uniform_decode_rows(words3: torch.Tensor, alphas: torch.Tensor, bits: int) -> torch.Tensor:
    """(peers, rows, 4·bits) + (peers,) α -> (peers, rows, 128) ``code·2α_p/s − α_p``."""
    return _rows(_uniform_vals, words3, alphas, bits)


def orthogonalize(p: torch.Tensor) -> torch.Tensor:
    """(rows, r) fp32 factor -> the same shape with its columns
    orthonormalized: ``orthogonalize._gs_padded`` op for op — modified
    Gram–Schmidt with one reorthogonalization pass per pivot, each pivot
    scaled by ``1/sqrt(max(v·v, 1e-30))``, so a zero column stays zero.
    The sums run in another order than the kernel's."""
    cols = []
    rest = p
    for _ in range(p.shape[1]):
        v = rest[:, 0:1]
        for u in cols:
            v = v - torch.sum(u * v) * u
        nrm = torch.sum(v * v)
        v = v * (torch.ones_like(nrm) / torch.sqrt(torch.clamp_min(nrm, GS_EPS)))
        cols.append(v)
        rest = rest[:, 1:]
        if rest.shape[1]:
            rest = rest - torch.sum(v * rest, dim=0, keepdim=True) * v
    return torch.cat(cols, dim=1)
