"""Decoder-only LM (dense / MoE / SSM / hybrid / VLM) and Whisper-style
encoder-decoder: the serving path.

The port of ``repro.models.transformer``'s serving part, for every family
of the zoo:

- A *unit* is the JAX package's scan step: one layer for uniform stacks; a
  superblock of ``attn_period`` sublayers for hybrids (Jamba: 1 attention +
  7 SSM sublayers a unit, MoE on every other one), its params and caches
  under ``sub{j}`` keys.  Params are dicts of tensors stacked on the unit
  axis, as JAX's scan stacks them; the forward loops over the units in
  Python.
- ``init_lm`` draws the JAX package's weights from the same key: the same
  splits, a key per unit (``split(ks[1], units)``, as JAX's ``vmap`` over
  them), ``fold_in(key, j)`` for sublayer j of a superblock, each leaf cast
  to ``param_dtype``.
- ``prefill`` runs the full prompt and returns the last position's logits
  and the caches, stacked on the unit axis: ``KVCache`` (one host
  ``length`` for every unit) for attention, ``ssm.SSMState`` for an SSM
  mixer, ``{"sub{j}": ...}`` for a superblock and ``{"self": KVCache,
  "cross_kv": (k, v)}`` for the encoder-decoder.  ``decode_step`` runs one
  token against them and **writes the caches in place**: it returns the
  same tensors (KV caches with the new length), so a caller that wants to
  keep a prefill's caches clones them.

The MoE load-balance loss is computed (``moe.moe_apply`` returns it) but
serving drops it.  The train path (``loss_fn``, the chunked cross-entropy,
the decomposed train entries) and the logical-axis trees come with the
train step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng

from .attention import (KVCache, attention_decode, attention_forward, attention_prefill,
                        attn_init, cross_attention_forward, cross_kv)
from .layers import apply_norm, dense_init, dtype_of, mlp_apply, mlp_init, norm_init
from .moe import dense_moe_apply, moe_apply, moe_init
from .rope import sincos_embedding, sincos_row
from .ssm import SSMState, init_ssm_state, ssm_decode, ssm_forward, ssm_init


@dataclasses.dataclass(frozen=True)
class SubDesc:
    mixer: str  # 'attn' | 'ssm'
    ffn: str    # 'mlp' | 'moe' | 'none'
    cross: bool = False


def unit_pattern(cfg) -> tuple[list[SubDesc], int]:
    """Sublayer descriptors for one scan unit + number of units."""
    if cfg.family == "hybrid":
        period = cfg.attn_period
        units = cfg.num_layers // period
        descs = []
        for j in range(period):
            mixer = "attn" if j == cfg.attn_offset else "ssm"
            ffn = "moe" if (cfg.moe is not None and j % cfg.moe.every == cfg.moe.every - 1) else "mlp"
            descs.append(SubDesc(mixer, ffn))
        return descs, units
    mixer = "ssm" if cfg.family == "ssm" else "attn"
    if cfg.moe is not None and cfg.moe.every == 1:
        ffn = "moe"
    elif cfg.d_ff <= 0:
        ffn = "none"  # pure-Mamba stacks are mixer-only
    else:
        ffn = "mlp"
    return [SubDesc(mixer, ffn)], cfg.num_layers


def _decoder_descs(cfg) -> tuple[list[SubDesc], int]:
    """Whisper-style decoder sublayers also cross-attend to the encoder."""
    descs, units = unit_pattern(cfg)
    if cfg.enc_dec:
        descs = [dataclasses.replace(d, cross=True) for d in descs]
    return descs, units


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _sublayer_init(key: torch.Tensor, cfg, desc: SubDesc, device) -> dict:
    ks = prng.split(key, 6)
    mixer_init = attn_init if desc.mixer == "attn" else ssm_init
    p = {"ln1": norm_init(cfg, cfg.d_model, device),
         "mixer": mixer_init(ks[0], cfg, cfg.d_model, device)}
    if desc.cross:
        p["lnx"] = norm_init(cfg, cfg.d_model, device)
        p["cross"] = attn_init(ks[2], cfg, cfg.d_model, device)
    if desc.ffn != "none":
        p["ln2"] = norm_init(cfg, cfg.d_model, device)
    if desc.ffn == "moe":
        p["ffn"] = moe_init(ks[1], cfg, cfg.d_model, device)
    elif desc.ffn == "mlp":
        p["ffn"] = mlp_init(ks[1], cfg, cfg.d_model, cfg.d_ff, dtype_of(cfg.param_dtype), device)
    return p


def _unit_init(key: torch.Tensor, cfg, descs: list, device) -> dict:
    if len(descs) == 1:
        return _sublayer_init(key, cfg, descs[0], device)
    return {f"sub{j}": _sublayer_init(prng.fold_in(key, j), cfg, d, device)
            for j, d in enumerate(descs)}


def _stacked(init_one, keys: torch.Tensor) -> dict:
    """``init_one(key)`` for every key, each leaf stacked on a new first
    axis; one unit's draws are alive at a time."""
    first = init_one(keys[0])

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = t.new_empty((len(keys),) + tuple(t.shape))
        out[0] = t
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    out = alloc(first)
    del first
    for i in range(1, len(keys)):
        fill(out, init_one(keys[i]), i)
    return out


def init_lm(key: torch.Tensor, cfg, device="cuda") -> dict:
    """The params tree, drawn from ``key`` as the JAX package's ``init_lm``
    draws it (its first result): a few ulp from JAX's float32 draws, as
    ``prng.normal`` is, before the cast to ``param_dtype``."""
    descs, units = _decoder_descs(cfg)
    ks = prng.split(key, 8)
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p: dict = {"embed": dense_init(ks[0], (cfg.vocab, d), d, dtype, device)}
    p["blocks"] = _stacked(lambda k: _unit_init(k, cfg, descs, device), prng.split(ks[1], units))
    p["final_norm"] = norm_init(cfg, d, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(ks[2], (d, cfg.vocab), d, dtype, device)
    if cfg.vlm_patches:
        p["projector"] = dense_init(ks[3], (cfg.vlm_vision_dim, d), cfg.vlm_vision_dim, dtype,
                                    device)
    if cfg.enc_dec:
        enc_desc = SubDesc("attn", "mlp")
        p["encoder"] = {
            "blocks": _stacked(lambda k: _sublayer_init(k, cfg, enc_desc, device),
                               prng.split(ks[4], cfg.num_enc_layers)),
            "final_norm": norm_init(cfg, d, device)}
    return p


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch reads its bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device="cuda") -> dict:
    """A JAX ``init_lm`` params tree pulled to the host (nested dicts of
    numpy arrays) -> the port's tree on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree).to(device)


def _unit(tree: dict, i: int) -> dict:
    """Unit ``i``'s slice of a tree stacked on the unit axis (views)."""
    return {k: _unit(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Sublayer / unit forward
# ---------------------------------------------------------------------------


def _ffn_apply(cfg, desc: SubDesc, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The sublayer's FFN on x (B, S, D); a few experts over few tokens take
    the dense path, as in the JAX package."""
    if desc.ffn == "moe":
        if cfg.moe.num_experts <= 4 and x.shape[0] * x.shape[1] < 4096:
            return dense_moe_apply(cfg, p["ffn"], x)[0]
        return moe_apply(cfg, p["ffn"], x)[0]
    return mlp_apply(cfg, p["ffn"], x)


def _sublayer_fwd(cfg, desc: SubDesc, p: dict, x: torch.Tensor, positions, mode: str, cache,
                  position, capacity=None):
    """Mixer (attention or SSM) then FFN, pre-norm, for ``mode`` prefill |
    encode | decode.  Returns (x, new_cache)."""
    h = apply_norm(cfg, p["ln1"], x)
    new_cache = cache
    win = cfg.sliding_window
    if desc.mixer == "ssm":
        if mode == "prefill":
            mx, new_cache = ssm_forward(cfg, p["mixer"], h, return_state=True)
        else:
            mx, new_cache = ssm_decode(cfg, p["mixer"], h, cache)
    elif mode == "prefill":
        mx, new_cache = attention_prefill(cfg, p["mixer"], h, positions, window=win,
                                          capacity=capacity)
    elif mode == "encode":
        mx = attention_forward(cfg, p["mixer"], h, positions, causal=False)
    else:
        mx, new_cache = attention_decode(cfg, p["mixer"], h, cache, position, window=win)
    x = x + mx
    if desc.ffn == "none":
        return x, new_cache
    return x + _ffn_apply(cfg, desc, p, apply_norm(cfg, p["ln2"], x)), new_cache


def _unit_fwd(cfg, descs: list, p: dict, x: torch.Tensor, positions, mode: str, cache,
              position, capacity=None):
    """One unit: a sublayer, or a superblock's sublayers in order with their
    caches under ``sub{j}``.  Returns (x, new_cache)."""
    if len(descs) == 1:
        return _sublayer_fwd(cfg, descs[0], p, x, positions, mode, cache, position, capacity)
    new_cache = {}
    for j, d in enumerate(descs):
        sub = cache[f"sub{j}"] if cache is not None else None
        x, new_cache[f"sub{j}"] = _sublayer_fwd(cfg, d, p[f"sub{j}"], x, positions, mode, sub,
                                                position, capacity)
    return x, new_cache


def _unit_fwd_with_cross(cfg, descs: list, p_u: dict, x: torch.Tensor, positions, enc_out,
                         capacity=None):
    """One unit's prefill, computing cross-KV from ``enc_out`` as needed."""
    if not cfg.enc_dec:
        return _unit_fwd(cfg, descs, p_u, x, positions, "prefill", None, None, capacity)
    h = apply_norm(cfg, p_u["ln1"], x)
    mx, kv_cache = attention_prefill(cfg, p_u["mixer"], h, positions,
                                     window=cfg.sliding_window, capacity=capacity)
    x = x + mx
    hx = apply_norm(cfg, p_u["lnx"], x)
    ekv = cross_kv(cfg, p_u["cross"], enc_out)
    x = x + cross_attention_forward(cfg, p_u["cross"], hx, ekv)
    x = x + mlp_apply(cfg, p_u["ffn"], apply_norm(cfg, p_u["ln2"], x))
    return x, {"self": kv_cache, "cross_kv": ekv}


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def _embed_tokens(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.rope == "sincos":
        pos = sincos_embedding(tokens.shape[1], cfg.d_model, x.device)
        x = x + pos[None].to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def _embed_decode_token(cfg, params: dict, token: torch.Tensor, position: int) -> torch.Tensor:
    x = params["embed"][token]
    if cfg.rope == "sincos":  # one sincos row at the token's position
        x = x + sincos_row(position, cfg.d_model, x.device)[None, None].to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def lm_head_weights(cfg, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _inject_vision(cfg, params: dict, x: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Replace the first ``vlm_patches`` positions with projected patch embeds."""
    cd = dtype_of(cfg.compute_dtype)
    proj = patches.to(cd) @ params["projector"].to(cd)
    return torch.cat([proj, x[:, cfg.vlm_patches:]], dim=1)


def encode_frames(cfg, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The audio encoder over precomputed frame embeddings (the conv
    frontend is a stub): sincos positions, bidirectional attention."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    x = x + sincos_embedding(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[:2])
    blocks, desc = params["encoder"]["blocks"], SubDesc("attn", "mlp")
    for i in range(cfg.num_enc_layers):
        x, _ = _sublayer_fwd(cfg, desc, _unit(blocks, i), x, positions, "encode", None, None)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


# ---------------------------------------------------------------------------
# Main entry points
# ---------------------------------------------------------------------------


class Batch(NamedTuple):
    tokens: torch.Tensor                  # (B, S) int64
    labels: torch.Tensor                  # (B, S) int64, -1 = masked
    positions: torch.Tensor | None = None  # (B,S) or (3,B,S) for mrope
    patches: torch.Tensor | None = None    # (B, P, vdim) VLM patch embeddings
    frames: torch.Tensor | None = None     # (B, enc_seq, D) audio frames


def _positions_for(cfg, batch: Batch) -> torch.Tensor:
    if batch.positions is not None:
        return batch.positions
    b, s = batch.tokens.shape
    return torch.arange(s, device=batch.tokens.device)[None].expand(b, s)


def _stack_caches(caches: list):
    """Per-unit caches -> one cache tree stacked on the unit axis (a KV
    cache keeps its host ``length``)."""
    c0 = caches[0]
    if isinstance(c0, KVCache):
        return KVCache(k=torch.stack([c.k for c in caches]),
                       v=torch.stack([c.v for c in caches]), length=c0.length)
    if isinstance(c0, dict):
        return {k: _stack_caches([c[k] for c in caches]) for k in c0}
    fields = [torch.stack(f) for f in zip(*caches)]   # SSMState or the cross (k, v)
    return SSMState(*fields) if isinstance(c0, SSMState) else tuple(fields)


def _unit_cache(caches, i: int):
    """Unit ``i``'s slice of a stacked cache tree (views: decode writes
    through them into the stacked tensors)."""
    if isinstance(caches, KVCache):
        return caches._replace(k=caches.k[i], v=caches.v[i])
    if isinstance(caches, dict):
        return {k: _unit_cache(v, i) for k, v in caches.items()}
    fields = [t[i] for t in caches]
    return SSMState(*fields) if isinstance(caches, SSMState) else tuple(fields)


def _with_lengths(caches, unit):
    """The stacked ``caches`` with the KV lengths of the last unit's new
    caches ``unit`` (everything else was written in place)."""
    if isinstance(caches, KVCache):
        return caches._replace(length=unit.length)
    if isinstance(caches, dict):
        return {k: _with_lengths(v, unit[k]) for k, v in caches.items()}
    return caches


def backbone(cfg, params: dict, batch: Batch, capacity=None):
    """Embed -> units (prefill) -> final norm.  Returns (hidden, caches)."""
    descs, units = _decoder_descs(cfg)
    x = _embed_tokens(cfg, params, batch.tokens)
    if cfg.vlm_patches:
        x = _inject_vision(cfg, params, x, batch.patches)
    positions = _positions_for(cfg, batch)
    enc_out = encode_frames(cfg, params, batch.frames) if cfg.enc_dec else None
    caches = []
    for i in range(units):
        x, c = _unit_fwd_with_cross(cfg, descs, _unit(params["blocks"], i), x, positions,
                                    enc_out, capacity)
        caches.append(c)
    return apply_norm(cfg, params["final_norm"], x), _stack_caches(caches)


def prefill(cfg, params: dict, batch: Batch, capacity=None):
    """Returns (last-token logits (B, V) float32, caches).  ``capacity``
    reserves cache room for subsequent decode steps."""
    hidden, caches = backbone(cfg, params, batch, capacity=capacity)
    last = hidden[:, -1]
    return (last @ lm_head_weights(cfg, params).to(last.dtype)).float(), caches


def decode_step(cfg, params: dict, token: torch.Tensor, caches, position: int):
    """One decode step.  token: (B, 1) integers; position: the token's
    absolute position (a host int).

    Returns (logits (B, V) float32, caches): the caches passed in, written
    in place, with the new length."""
    descs, units = _decoder_descs(cfg)
    x = _embed_decode_token(cfg, params, token, position)
    new_u = caches
    for i in range(units):
        p_u = _unit(params["blocks"], i)
        cache_u = _unit_cache(caches, i)
        if cfg.enc_dec:
            h = apply_norm(cfg, p_u["ln1"], x)
            mx, new_self = attention_decode(cfg, p_u["mixer"], h, cache_u["self"], position,
                                            window=cfg.sliding_window)
            y = x + mx
            hx = apply_norm(cfg, p_u["lnx"], y)
            y = y + cross_attention_forward(cfg, p_u["cross"], hx, cache_u["cross_kv"])
            x = y + mlp_apply(cfg, p_u["ffn"], apply_norm(cfg, p_u["ln2"], y))
            new_u = {"self": new_self, "cross_kv": cache_u["cross_kv"]}
        else:
            x, new_u = _unit_fwd(cfg, descs, p_u, x, None, "decode", cache_u, position)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = (x[:, 0] @ lm_head_weights(cfg, params).to(x.dtype)).float()
    return logits, _with_lengths(caches, new_u)


# ---------------------------------------------------------------------------
# Cache construction (zeros; serving starts from prefill in practice, but
# tests need shape-correct caches without running prefill).
# ---------------------------------------------------------------------------


def init_caches(cfg, batch: int, cache_len: int, device="cuda"):
    descs, units = _decoder_descs(cfg)
    dh = cfg.resolved_head_dim
    dt = dtype_of(cfg.compute_dtype)
    eff_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    # full (non-rolling) caches leave the last slot free: decode appends at
    # cache.length
    fill = eff_len if cfg.sliding_window else eff_len - 1

    def zeros(s):
        return torch.zeros((units, batch, s, cfg.num_kv_heads, dh), dtype=dt, device=device)

    def one(desc):
        if cfg.enc_dec:
            return {"self": KVCache(k=zeros(eff_len), v=zeros(eff_len), length=fill),
                    "cross_kv": (zeros(cfg.enc_seq), zeros(cfg.enc_seq))}
        if desc.mixer == "attn":
            return KVCache(k=zeros(eff_len), v=zeros(eff_len), length=fill)
        state = init_ssm_state(cfg, batch, torch.float32, device)
        return SSMState(*(t.expand((units,) + tuple(t.shape)).contiguous() for t in state))

    if len(descs) == 1:
        return one(descs[0])
    return {f"sub{j}": one(d) for j, d in enumerate(descs)}
