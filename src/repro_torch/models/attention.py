"""GQA attention: chunked-flash for prefill and encoders, cached decode,
cross-attention.

The port of ``repro.models.attention``.  Its memory-efficient attention is
an online softmax over (q-chunk, kv-chunk) tiles in plain tensor ops, as
the JAX package's is plain ``jnp`` (no Pallas kernel), with a Python loop
where JAX scans.  The working set per tile is one (B, qc, H, kc) float32
score tile.

Sliding-window decode uses a rolling KV cache of window size: position
enters keys via RoPE *before* caching, so attention is permutation-invariant
over cache slots and no unrotation is needed.

On a model axis the weights hold this rank's heads: ``wq``, ``wk`` and
``wv`` by columns (whole heads, a rank's KV heads serving its own query
heads), ``wo`` by rows, its partial output summed over the model group
(``dist.sharding``); a rank's KV cache holds its own KV heads.

Caches are written in place: :func:`attention_decode` stores the new key
and value into the cache's tensors and returns them with the new length.
A cache's ``length`` is a host int, so the decode loop never waits on the
device for it.

Under autograd (the train path) each (q-chunk, kv-chunk) tile step is
checkpointed, as the JAX package checkpoints its ``kv_step``: the backward
keeps a tile's inputs (the running max, sum and accumulator), not its
(B, qc, H, kc) probabilities, and recomputes the tile.  The recomputation
repeats the forward's ops, so the gradients are autograd's through the
plain loop.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.dist import sharding

from .layers import dense_init, dtype_of
from .rope import apply_positional

NEG_INF = -1e30


def attn_init(key: torch.Tensor, cfg, d: int, device) -> dict:
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    ks = prng.split(key, 4)
    dtype = dtype_of(cfg.param_dtype)
    return {"wq": dense_init(ks[0], (d, hq * dh), d, dtype, device),
            "wk": dense_init(ks[1], (d, hkv * dh), d, dtype, device),
            "wv": dense_init(ks[2], (d, hkv * dh), d, dtype, device),
            "wo": dense_init(ks[3], (hq * dh, d), hq * dh, dtype, device)}


def attn_axes() -> dict:
    """The logical axes of :func:`attn_init`'s leaves (JAX's ``attn_init``'s
    second result, self- and cross-attention alike)."""
    return {"wq": ("embed_fsdp", "heads"), "wk": ("embed_fsdp", "heads"),
            "wv": ("embed_fsdp", "heads"), "wo": ("heads", "embed_fsdp")}


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:-1]) + (n, dh))


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target (keeps tiles even)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _repeat_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    hkv = k.shape[2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def _kv_tiles(q_idx: int, qc: int, kc: int, nk: int, causal: bool) -> int:
    """How many kv tiles q-chunk ``q_idx`` visits: causally, none that lies
    wholly above the diagonal.  Such a tile would add p = exp(NEG_INF - m) = 0
    and rescale by exp(0) = 1, so leaving it out gives the same bits (every
    row has met its own diagonal tile by then, so its m is finite)."""
    if not causal:
        return nk
    return min(nk, ((q_idx + 1) * qc - 1) // kc + 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int | None = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention.  q: (B,Sq,H,Dh), k/v: (B,Skv,H,Dh).

    Tiles are the largest divisors of the lengths up to ``q_chunk`` and
    ``kv_chunk`` (:func:`_pick_chunk`), so a prime length runs 1-wide tiles,
    one Python iteration each: serve lengths with large divisors.  Fully
    masked tiles before a row's first valid one are kept, as in JAX: the
    first valid tile's correction exp(NEG_INF - m) = 0 wipes what they add.
    """
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    qc = _pick_chunk(sq, q_chunk)
    kc = _pick_chunk(skv, kv_chunk)
    nq, nk = sq // qc, skv // kc
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    dev = q.device
    k32, v32 = k.float(), v.float()

    # checkpoint the tiles wherever autograd records them
    step = functools.partial(checkpoint, _kv_step, use_reentrant=False) if (
        torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    ) else _kv_step

    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * qc:(qi + 1) * qc].float()
        qpos = qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, qc, h), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, qc, h), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, h, dh), dtype=torch.float32, device=dev)
        for ki in range(_kv_tiles(qi, qc, kc, nk, causal)):
            k_blk, v_blk = k32[:, ki * kc:(ki + 1) * kc], v32[:, ki * kc:(ki + 1) * kc]
            kpos = ki * kc + torch.arange(kc, device=dev)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            m, l, acc = step(q_blk, k_blk, v_blk, mask, m, l, acc, scale)
        outs.append((acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype))
    return torch.cat(outs, dim=1)


def _kv_step(q_blk: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, mask: torch.Tensor,
             m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, scale: float):
    """One kv tile of the online softmax: (m, l, acc) -> their update."""
    s = torch.einsum("bqhd,bkhd->bqhk", q_blk, k_blk) * scale
    s = torch.where(mask[None, :, None, :], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v_blk)
    return m_new, l, acc


class KVCache(NamedTuple):
    k: torch.Tensor     # ([U,] B, S_cache, Hkv, Dh), RoPE already applied
    v: torch.Tensor     # ([U,] B, S_cache, Hkv, Dh)
    length: int         # valid positions (== S_cache when full), equal across units


def _local_heads(cfg, p: dict) -> tuple[int, int, bool]:
    """(query heads, KV heads) this rank's weights hold, and whether they are
    split over the model axis: ``wq``/``wk``/``wv`` by columns (whole
    heads; each rank's KV heads serve its own query heads), ``wo`` by
    rows."""
    dh = cfg.resolved_head_dim
    hq, hkv = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    return hq, hkv, hq != cfg.num_heads


def _qkv(cfg, p: dict, x: torch.Tensor):
    dh = cfg.resolved_head_dim
    hq, hkv, _ = _local_heads(cfg, p)
    return (_split_heads(x @ p["wq"], hq, dh),
            _split_heads(x @ p["wk"], hkv, dh),
            _split_heads(x @ p["wv"], hkv, dh))


def _merge_heads(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return y.reshape(tuple(x.shape[:-1]) + (y.shape[-2] * y.shape[-1],))


def _out(y: torch.Tensor, wo: torch.Tensor, split: bool) -> torch.Tensor:
    """The output projection; a row-split ``wo``'s partial sums added over
    the model group."""
    out = y @ wo
    return sharding.reduce_from_model(out) if split else out


def attention_forward(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                      causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Full-sequence self-attention: the train path's (causal, with the
    config's sliding window) and the encoder's (bidirectional)."""
    hq, _, split = _local_heads(cfg, p)
    if split:
        x = sharding.copy_to_model(x)
    q, k, v = _qkv(cfg, p, x)
    q = apply_positional(cfg, q, positions)
    k = apply_positional(cfg, k, positions)
    out = flash_attention(q, _repeat_kv(k, hq), _repeat_kv(v, hq), causal=causal, window=window)
    return _out(_merge_heads(out, x), p["wo"], split)


def attention_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                      window: int | None = None, capacity: int | None = None):
    """Prefill: returns (y, KVCache with rotated keys).

    ``capacity`` > seq_len leaves room for later decode steps (decode
    appends at ``cache.length``); a window keeps the last ``window``
    positions only."""
    hq, _, split = _local_heads(cfg, p)
    q, k, v = _qkv(cfg, p, x)
    q = apply_positional(cfg, q, positions)
    k = apply_positional(cfg, k, positions)
    y = flash_attention(q, _repeat_kv(k, hq), _repeat_kv(v, hq), causal=True, window=window)
    y = _out(_merge_heads(y, x), p["wo"], split)
    if window is not None:
        k, v = k[:, -window:], v[:, -window:]
    length = k.shape[1]
    if capacity is not None and capacity > length:
        kp = k.new_zeros((k.shape[0], capacity) + tuple(k.shape[2:]))
        vp = v.new_zeros((v.shape[0], capacity) + tuple(v.shape[2:]))
        kp[:, :length], vp[:, :length] = k, v
        k, v = kp, vp
    return y, KVCache(k=k, v=v, length=length)


def attention_decode(cfg, p: dict, x: torch.Tensor, cache: KVCache, position: int, *,
                     window: int | None = None):
    """One token (x: (B, 1, D)) at absolute ``position`` against ``cache``.

    Writes the new key and value into ``cache.k``/``cache.v`` in place and
    returns (y, KVCache(k, v, new length)).  A rolling (windowed) cache
    takes slot ``position % S_cache``; a full one appends at ``length``,
    clamped to the last slot as JAX's ``dynamic_update_slice`` clamps."""
    dh = cfg.resolved_head_dim
    b = x.shape[0]
    hq, hkv, split = _local_heads(cfg, p)
    pos2 = torch.full((b, 1), position, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(cfg, p, x)
    q = apply_positional(cfg, q, pos2)
    k_new = apply_positional(cfg, k_new, pos2)
    s_cache = cache.k.shape[1]
    slot = position % s_cache if window is not None else min(cache.length, s_cache - 1)
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    new_len = min(cache.length + 1, s_cache)

    # Grouped-query attention against the cache without repeating its heads:
    # q is viewed as (B, 1, Hkv, rep, Dh).  JAX contracts the raw cache with
    # float32 accumulation; the products of its (bfloat16) values are exact
    # in float32, so upcasting the valid slots first gives the same sums.
    rep = hq // max(hkv, 1)
    qg = q.reshape(b, 1, hkv, rep, dh).float()
    kv_k, kv_v = cache.k[:, :new_len].float(), cache.v[:, :new_len]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    s = torch.einsum("bqhrd,bkhd->bqhrk", qg, kv_k) * scale
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhrk,bkhd->bqhrd", w.to(kv_v.dtype).float(), kv_v.float())
    out = out.to(x.dtype).reshape(b, 1, hq * dh)
    return _out(out, p["wo"], split), KVCache(k=cache.k, v=cache.v, length=new_len)


def cross_attention_forward(cfg, p: dict, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Decoder cross-attention; enc_kv = (k, v) precomputed from encoder output."""
    q = _split_heads(x @ p["wq"], cfg.num_heads, cfg.resolved_head_dim)
    k, v = enc_kv
    out = flash_attention(q, _repeat_kv(k, cfg.num_heads), _repeat_kv(v, cfg.num_heads),
                          causal=False, q_chunk=1024, kv_chunk=max(64, min(1024, k.shape[1])))
    return _merge_heads(out, x) @ p["wo"]


def cross_kv(cfg, p: dict, enc_out: torch.Tensor):
    dh = cfg.resolved_head_dim
    return (_split_heads(enc_out @ p["wk"], cfg.num_kv_heads, dh),
            _split_heads(enc_out @ p["wv"], cfg.num_kv_heads, dh))
