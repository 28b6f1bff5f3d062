"""Public wrappers around the port's kernels: layout, RNG draw and dispatch.

The counterpart of ``repro.kernels.ops``.  Each wrapper draws the
stochastic-rounding uniforms on the (rows, 128) tile of a flat bucket
(element i's counters follow from i and the tile's size, exactly as in the
JAX package) and sends the operands to the kernel when they lie on the
card or to the plain version in ``kernels.ref`` when they lie on the CPU.
The plain versions take the bucket zero-padded to that tile.  On the card
the statistics kernels K1 and K10, the fused encodes K2, K3, K6 and K7 and
the packed per-tensor encodes K16 and K17 take the bucket, and the decodes
K4, K5, K8 and K9 the stacked wire, as it lies; the per-tensor kernels
K12–K15 take the padded tile there too.
There is no switch between the two: the device decides, and a card tensor
either launches its kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.quantizers import packed_size

from . import decode as _d
from . import encode_fused as _e
from . import orthogonalize as _o
from . import quantize as _q
from . import ref
from . import stats as _s

LANES = _s.LANES


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for tensors on {x.device}")


def _to_2d(x: torch.Tensor, dtype=torch.float32,
           n: int | None = None) -> tuple[torch.Tensor, int]:
    """``x`` flat, zero-padded to the (ceil(n/128), 128) tile of its code
    length n (its own length by default), and n."""
    m = x.numel()
    n = m if n is None else n
    if n < m:
        raise ValueError(f"code length n={n} below the bucket's {m} elements")
    rows = -(-n // LANES)
    x2 = torch.zeros(rows * LANES, dtype=dtype, device=x.device)
    x2[:m] = x.reshape(-1)
    return x2.reshape(rows, LANES), n


class BucketStats(NamedTuple):
    """One-pass statistics of a flat gradient bucket."""

    counts: torch.Tensor    # (NUM_BINS,) log2-spaced |g| histogram counts
    log_sums: torch.Tensor  # (NUM_BINS,) per-bin sums of ln|g|
    g_max: torch.Tensor     # scalar max |g|
    g_sum: torch.Tensor     # scalar sum g
    g_sumsq: torch.Tensor   # scalar sum g²


def _stats(out: torch.Tensor) -> BucketStats:
    return BucketStats(counts=out[0], log_sums=out[1], g_max=out[2, 0],
                       g_sum=out[3, 0], g_sumsq=out[4, 0])


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def bucket_stats(g: torch.Tensor) -> BucketStats:
    """Histogram + Hill-sum + max/moments pass over a flat bucket (K10)."""
    if _on_card(g):
        return _stats(_s.bucket_stats_flat(_f32(g.reshape(-1)), g.numel()))
    g2, n = _to_2d(g)
    return _stats(ref.bucket_stats(g2, n))


def ef_correct_stats(g: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, BucketStats]:
    """One pass: ``c = g + e`` plus the statistics of c (K1).
    Returns ``(corrected (n,) fp32, BucketStats)``."""
    if _on_card(g):
        c, out = _e.ef_correct_stats_flat(_f32(g.reshape(-1)), _f32(e.reshape(-1)), g.numel())
        return c, _stats(out)
    g2, n = _to_2d(g)
    e2, _ = _to_2d(e)
    c2, out = ref.ef_correct_stats(g2, e2, n)
    return c2.reshape(-1)[:n], _stats(out)


def _alpha(alpha: torch.Tensor) -> torch.Tensor:
    return _f32(alpha.reshape(1))


def _draw(g: torch.Tensor, key: torch.Tensor):
    """``g`` padded to (rows, 128), its element count, and the uniforms
    drawn on that padded tile."""
    g2, n = _to_2d(g)
    return g2, n, prng.uniform(key, g2.shape, device=g2.device)


def _encode_tile(kernel, plain, g: torch.Tensor, meta: torch.Tensor, bits: int,
                 key: torch.Tensor, n: int | None):
    """Encode flat ``g`` at code length n (g's length by default; elements
    past g count as zero) with ``rand`` drawn on the (ceil(n/128), 128)
    tile: the kernel on g as it lies (``encode_fused.encode_flat``), or the
    plain version on g zero-padded to the tile.  Returns their outputs on
    the tile, and n."""
    n = g.numel() if n is None else n
    rand = prng.uniform(key, (-(-n // LANES), LANES), device=g.device)
    if _on_card(g):
        return _e.encode_flat(kernel, _f32(g.reshape(-1)), n, rand, meta, bits), n
    return plain(_to_2d(g, n=n)[0], rand, meta, n, bits), n


def _encode(kernel, plain, g: torch.Tensor, meta: torch.Tensor, bits: int, key: torch.Tensor,
            n: int | None = None):
    """:func:`_encode_tile` for K2, K3, K6 and K7.  Returns the
    ``packed_size(n, bits)`` words, and g's residual where the kernel
    writes one."""
    out, n = _encode_tile(kernel, plain, g, meta, bits, key, n)
    words, resid = out if isinstance(out, tuple) else (out, None)
    words = words.reshape(-1)[:packed_size(n, bits)]
    return words if resid is None else (words, resid.reshape(-1)[:g.numel()])


def _encode_packed(kernel, plain, g: torch.Tensor, meta: torch.Tensor, bits: int,
                   key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_encode_tile` for K16 and K17 at g's own length: the
    ``packed_size(n, bits)`` words and the flat uint8 codes."""
    (codes, words), n = _encode_tile(kernel, plain, g, meta, bits, key, None)
    return words.reshape(-1)[:packed_size(n, bits)], codes.reshape(-1)[:n].to(torch.uint8)


def codebook_encode_pack_residual(g: torch.Tensor, levels: torch.Tensor, bits: int,
                                  key: torch.Tensor, n: int | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic codebook encode + bit-pack + EF residual (K2).

    Returns ``(words, residual)``: the ``packed_size(n, bits)`` int32 wire
    words (the bits of ``pack_codes``) and the exact ``g − levels[code]``
    of g's elements.  ``n`` (g's length by default) is the code length: g
    is encoded as if zero-padded to n elements.
    """
    return _encode(_e.codebook_encode_pack_resid_2d, ref.codebook_encode_pack_residual, g,
                   _f32(levels), bits, key, n)


def uniform_encode_pack_residual(g: torch.Tensor, alpha: torch.Tensor, bits: int,
                                 key: torch.Tensor, n: int | None = None
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated uniform stochastic encode onto [−α, α] + bit-pack + EF
    residual ``g − (code·2α/s − α)`` (K3), ``n`` as in
    :func:`codebook_encode_pack_residual`.  ``alpha`` stays on the device."""
    return _encode(_e.uniform_encode_pack_resid_2d, ref.uniform_encode_pack_residual, g,
                   _alpha(alpha), bits, key, n)


def codebook_encode_pack(g: torch.Tensor, levels: torch.Tensor, bits: int,
                         key: torch.Tensor) -> torch.Tensor:
    """Codebook encode + bit-pack, words only (K6)."""
    return _encode(_e.codebook_encode_pack_2d, ref.codebook_encode_pack, g, _f32(levels),
                   bits, key)


def uniform_encode_pack(g: torch.Tensor, alpha: torch.Tensor, bits: int,
                        key: torch.Tensor) -> torch.Tensor:
    """Uniform encode + bit-pack, words only (K7)."""
    return _encode(_e.uniform_encode_pack_2d, ref.uniform_encode_pack, g, _alpha(alpha), bits,
                   key)


def uniform_encode(g: torch.Tensor, alpha: torch.Tensor, bits: int,
                   key: torch.Tensor) -> torch.Tensor:
    """Truncate + uniform stochastic encode onto [−α, α] (K12).  Returns
    flat uint8 codes."""
    g2, n, rand = _draw(g, key)
    codes = (_q.uniform_encode_2d if _on_card(g2) else ref.uniform_encode)(
        g2, rand, _alpha(alpha), bits)
    return codes.reshape(-1)[:n].to(torch.uint8)


def uniform_decode(codes: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """Flat codes -> ``code·(2α/s) − α`` (K13)."""
    c2, n = _to_2d(codes.to(torch.int32), torch.int32)
    vals = (_q.uniform_decode_2d if _on_card(c2) else ref.uniform_decode)(c2, _alpha(alpha), bits)
    return vals.reshape(-1)[:n]


def uniform_encode_packed(g: torch.Tensor, alpha: torch.Tensor, bits: int,
                          key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncate + uniform stochastic encode + bit-pack (K16).  Returns
    ``(words, codes)``: the ``packed_size(n, bits)`` int32 wire words (the
    bits of ``pack_codes`` of the codes) and the flat uint8 codes."""
    return _encode_packed(_q.uniform_encode_pack_2d, ref.uniform_encode_pack_codes, g,
                          _alpha(alpha), bits, key)


def codebook_encode_packed(g: torch.Tensor, levels: torch.Tensor, bits: int,
                           key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Codebook stochastic encode + bit-pack onto ``levels`` (K17); returns
    ``(words, codes)`` as :func:`uniform_encode_packed`."""
    return _encode_packed(_q.codebook_encode_pack_2d, ref.codebook_encode_pack_codes, g,
                          _f32(levels), bits, key)


def codebook_encode(g: torch.Tensor, levels: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Truncate + codebook stochastic encode onto ``levels`` (K14).
    Returns flat uint8 codes."""
    g2, n, rand = _draw(g, key)
    codes = (_q.codebook_encode_2d if _on_card(g2) else ref.codebook_encode)(
        g2, rand, _f32(levels))
    return codes.reshape(-1)[:n].to(torch.uint8)


def _encode_leaves(segmented, plain, gs: list, metas: list, keys: list, *per_leaf) -> list:
    """Each of ``gs`` padded to (rows_i, 128) with its uniforms drawn on
    that tile by ``keys[i]``, then one ``segmented`` launch (its ``plain``
    version on the CPU) for every ``MAX_SEGMENTS`` of them, on ``metas[i]``
    and each list of ``per_leaf``; returns the flat uint8 codes of each."""
    drawn = [_draw(g, k) for g, k in zip(gs, keys)]
    out = []
    for a in range(0, len(drawn), _q.MAX_SEGMENTS):
        part = drawn[a:a + _q.MAX_SEGMENTS]
        g2s, rands = [d[0] for d in part], [d[2] for d in part]
        encode = segmented if _on_card(g2s[0]) else plain
        codes = encode(g2s, rands, *[x[a:a + _q.MAX_SEGMENTS] for x in (metas, *per_leaf)])
        row = 0
        for g2, n, _ in part:
            out.append(codes[row:row + g2.shape[0]].reshape(-1)[:n].to(torch.uint8))
            row += g2.shape[0]
    return out


def codebook_encode_leaves(gs: list, levels: list, keys: list) -> list:
    """:func:`codebook_encode` over a list of tensors, tensor i onto
    ``levels[i]`` with ``keys[i]``: one segmented K14 launch for every
    ``MAX_SEGMENTS`` of them.  Returns the flat uint8 codes of each,
    bitwise :func:`codebook_encode`'s."""
    return _encode_leaves(_q.codebook_encode_segments, ref.codebook_encode_segments, gs,
                          [_f32(lv) for lv in levels], keys)


def uniform_encode_leaves(gs: list, alphas: list, bits: list, keys: list) -> list:
    """:func:`uniform_encode` over a list of tensors, tensor i onto [−α_i,
    α_i] at ``bits[i]`` with ``keys[i]``: one segmented K12 launch for every
    ``MAX_SEGMENTS`` of them.  Returns the flat uint8 codes of each,
    bitwise :func:`uniform_encode`'s."""
    return _encode_leaves(_q.uniform_encode_segments, ref.uniform_encode_segments, gs,
                          [_alpha(a) for a in alphas], keys, list(bits))


def codebook_decode(codes: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Flat codes -> ``levels[code]`` (K15)."""
    c2, n = _to_2d(codes.to(torch.int32), torch.int32)
    vals = (_q.codebook_decode_2d if _on_card(c2) else ref.codebook_decode)(c2, _f32(levels))
    return vals.reshape(-1)[:n]


def _to_words3(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """(peers, packed_size(n, bits)) int32 -> (peers, rows, 4·bits), zero-padded."""
    p, w = words.shape
    if w != packed_size(n, bits):
        raise ValueError(f"wire has {w} words per peer; {n} elements at {bits} bits need "
                         f"{packed_size(n, bits)}")
    rows = -(-n // LANES)
    wc = _d.words_per_row(bits)
    out = torch.zeros((p, rows * wc), dtype=torch.int32, device=words.device)
    out[:, :w] = words
    return out.reshape(p, rows, wc)


def _decode(kernel, plain, words: torch.Tensor, meta: torch.Tensor, n: int, bits: int):
    """The kernel on the wire as it lies (its rows may be strided), or the
    plain version on the wire zero-padded to (peers, rows, 4·bits)."""
    if _on_card(words):
        return _d.from_wire(kernel, words, meta, n, bits)
    return plain(_to_words3(words, n, bits), meta, bits)


def codebook_decode_reduce(words: torch.Tensor, levels: torch.Tensor, n: int,
                           bits: int) -> torch.Tensor:
    """Unpack + codebook dequant + peer mean (K4); ``words``: (peers,
    packed_size(n, bits)) int32, each row contiguous, ``levels``: (peers,
    s+1).  Returns (n,)."""
    out = _decode(_d.codebook_decode_reduce_3d, ref.codebook_decode_reduce, words,
                  _f32(levels), n, bits)
    return out.reshape(-1)[:n]


def uniform_decode_reduce(words: torch.Tensor, alphas: torch.Tensor, n: int,
                          bits: int) -> torch.Tensor:
    """Unpack + uniform dequant ``code·2α_p/s − α_p`` + peer mean (K5);
    ``alphas``: (peers,).  Returns (n,)."""
    out = _decode(_d.uniform_decode_reduce_3d, ref.uniform_decode_reduce, words,
                  _f32(alphas), n, bits)
    return out.reshape(-1)[:n]


def codebook_decode_rows(words: torch.Tensor, levels: torch.Tensor, n: int,
                         bits: int) -> torch.Tensor:
    """Unpack + codebook dequant, one (n,) row per peer (K8): the all-gather
    phase-2 sites, where peer j's decode is output chunk j."""
    out = _decode(_d.codebook_decode_rows_3d, ref.codebook_decode_rows, words, _f32(levels),
                  n, bits)
    return out.reshape(words.shape[0], -1)[:, :n]


def uniform_decode_rows(words: torch.Tensor, alphas: torch.Tensor, n: int,
                        bits: int) -> torch.Tensor:
    """Unpack + uniform dequant, one (n,) row per peer (K9)."""
    out = _decode(_d.uniform_decode_rows_3d, ref.uniform_decode_rows, words, _f32(alphas),
                  n, bits)
    return out.reshape(words.shape[0], -1)[:, :n]


def orthogonalize(p: torch.Tensor) -> torch.Tensor:
    """Gram–Schmidt orthonormalization of a tall-skinny (rows, r) factor
    (K11): PowerSGD's ``P̂ = orth(M @ Q)``."""
    p = _f32(p)
    return _o.orthogonalize_2d(p) if _on_card(p) else ref.orthogonalize(p)
