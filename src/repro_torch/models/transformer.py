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

The train path: :func:`loss_fn` runs :func:`backbone` in ``"train"`` mode
(full sequence, no caches; each unit checkpointed when ``cfg.remat``, as
JAX checkpoints its scan step) and the chunked cross-entropy
(:func:`chunked_xent`: a loop over sequence chunks that never builds the
(B, S, V) logits), plus ``AUX_LOSS_WEIGHT`` times the MoE load-balance
loss summed over units.  Its gradients are ``torch.autograd``'s.  The
decomposed entries (:func:`outer_params`, :func:`embed_fn`,
:func:`unit_fn`, :func:`sublayer_fn`, :func:`head_fn`) are the pieces the
layer-streamed train step runs one unit at a time.  Serving computes the
aux loss too and drops it.

:func:`logical_axes` is the JAX package's second result of ``init_lm``,
the tree ``dist.sharding`` maps onto a mesh.  On a model axis (inside
``dist.sharding.axis_rules``) a rank holds its slices and the layers read
the split from their shapes: attention over its own heads, the MLP over
its block of ``d_ff``, the embedding and the head over its block of the
vocab (a masked lookup summed over the model group; a distributed
log-softmax in :func:`chunked_xent`; logits gathered whole for serving).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.dist import sharding

from .attention import (KVCache, attention_decode, attention_forward, attention_prefill,
                        attn_axes, attn_init, cross_attention_forward, cross_kv)
from .layers import (apply_norm, dense_init, dtype_of, mlp_apply, mlp_axes, mlp_init, norm_axes,
                     norm_init)
from .moe import dense_moe_apply, moe_apply, moe_axes, moe_init
from .rope import sincos_embedding, sincos_row
from .ssm import SSMState, init_ssm_state, ssm_axes, ssm_decode, ssm_forward, ssm_init

AUX_LOSS_WEIGHT = 0.01


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


def _sublayer_axes(cfg, desc: SubDesc) -> dict:
    la = {"ln1": norm_axes(cfg), "mixer": attn_axes() if desc.mixer == "attn" else ssm_axes()}
    if desc.cross:
        la["lnx"] = norm_axes(cfg)
        la["cross"] = attn_axes()
    if desc.ffn != "none":
        la["ln2"] = norm_axes(cfg)
    if desc.ffn == "moe":
        la["ffn"] = moe_axes()
    elif desc.ffn == "mlp":
        la["ffn"] = mlp_axes(cfg)
    return la


def _stack_axes(tree: dict) -> dict:
    """A unit's axes with the stacking axis ``"layers"`` in front."""
    return {k: _stack_axes(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in tree.items()}


def logical_axes(cfg) -> dict:
    """The logical-axes tree of :func:`init_lm`'s params: the second result
    of the JAX package's ``init_lm``, for every family (``dist.sharding``
    maps it onto a mesh)."""
    descs, _ = _decoder_descs(cfg)
    unit = (_sublayer_axes(cfg, descs[0]) if len(descs) == 1 else
            {f"sub{j}": _sublayer_axes(cfg, d) for j, d in enumerate(descs)})
    la: dict = {"embed": ("vocab", "embed_fsdp"), "blocks": _stack_axes(unit),
                "final_norm": norm_axes(cfg)}
    if not cfg.tie_embeddings:
        la["lm_head"] = ("embed_fsdp", "vocab")
    if cfg.vlm_patches:
        la["projector"] = (None, "embed_fsdp")
    if cfg.enc_dec:
        la["encoder"] = {"blocks": _stack_axes(_sublayer_axes(cfg, SubDesc("attn", "mlp"))),
                         "final_norm": norm_axes(cfg)}
    return la


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


def _units(tree: dict, n: int) -> list:
    """Every unit's slice of a tree stacked on the unit axis: views from one
    ``unbind`` a leaf, so the backward stacks the units' gradients into the
    stacked leaf's once."""
    per = {k: _units(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: per[k][i] for k in per} for i in range(n)]


# ---------------------------------------------------------------------------
# Sublayer / unit forward
# ---------------------------------------------------------------------------


def _ffn_apply(cfg, desc: SubDesc, p: dict, x: torch.Tensor):
    """The sublayer's FFN on x (B, S, D): (y, aux), aux the MoE
    load-balance loss (a float32 scalar; 0.0 without experts).  A few
    experts over few tokens take the dense path, as in the JAX package."""
    if desc.ffn == "moe":
        if cfg.moe.num_experts <= 4 and x.shape[0] * x.shape[1] < 4096:
            return dense_moe_apply(cfg, p["ffn"], x)
        return moe_apply(cfg, p["ffn"], x)
    return mlp_apply(cfg, p["ffn"], x), 0.0


def _sublayer_fwd(cfg, desc: SubDesc, p: dict, x: torch.Tensor, positions, mode: str, cache,
                  position, capacity=None):
    """Mixer (attention or SSM) then FFN, pre-norm, for ``mode`` train |
    prefill | encode | decode.  Returns (x, new_cache, aux)."""
    h = apply_norm(cfg, p["ln1"], x)
    new_cache = cache
    win = cfg.sliding_window
    if desc.mixer == "ssm":
        if mode == "train":
            mx = ssm_forward(cfg, p["mixer"], h)
        elif mode == "prefill":
            mx, new_cache = ssm_forward(cfg, p["mixer"], h, return_state=True)
        else:
            mx, new_cache = ssm_decode(cfg, p["mixer"], h, cache)
    elif mode == "train":
        mx = attention_forward(cfg, p["mixer"], h, positions, causal=True, window=win)
    elif mode == "prefill":
        mx, new_cache = attention_prefill(cfg, p["mixer"], h, positions, window=win,
                                          capacity=capacity)
    elif mode == "encode":
        mx = attention_forward(cfg, p["mixer"], h, positions, causal=False)
    else:
        mx, new_cache = attention_decode(cfg, p["mixer"], h, cache, position, window=win)
    x = x + mx
    if desc.ffn == "none":
        return x, new_cache, 0.0
    y, aux = _ffn_apply(cfg, desc, p, apply_norm(cfg, p["ln2"], x))
    return x + y, new_cache, aux


def _unit_fwd(cfg, descs: list, p: dict, x: torch.Tensor, positions, mode: str, cache,
              position, capacity=None):
    """One unit: a sublayer, or a superblock's sublayers in order with their
    caches under ``sub{j}``.  Returns (x, new_cache, aux)."""
    if len(descs) == 1:
        return _sublayer_fwd(cfg, descs[0], p, x, positions, mode, cache, position, capacity)
    new_cache, aux_total = {}, 0.0
    for j, d in enumerate(descs):
        sub = cache[f"sub{j}"] if cache is not None else None
        x, new_cache[f"sub{j}"], aux = _sublayer_fwd(cfg, d, p[f"sub{j}"], x, positions, mode,
                                                     sub, position, capacity)
        aux_total = aux_total + aux
    return x, new_cache, aux_total


def _unit_fwd_with_cross(cfg, descs: list, p_u: dict, x: torch.Tensor, positions, mode: str,
                         enc_out, capacity=None):
    """One unit's train or prefill forward, computing cross-KV from
    ``enc_out`` as needed.  Returns (x, cache or None, aux)."""
    if not cfg.enc_dec:
        return _unit_fwd(cfg, descs, p_u, x, positions, mode, None, None, capacity)
    h = apply_norm(cfg, p_u["ln1"], x)
    kv_cache = None
    if mode == "prefill":
        mx, kv_cache = attention_prefill(cfg, p_u["mixer"], h, positions,
                                         window=cfg.sliding_window, capacity=capacity)
    else:
        mx = attention_forward(cfg, p_u["mixer"], h, positions, causal=True,
                               window=cfg.sliding_window)
    x = x + mx
    hx = apply_norm(cfg, p_u["lnx"], x)
    ekv = cross_kv(cfg, p_u["cross"], enc_out)
    x = x + cross_attention_forward(cfg, p_u["cross"], hx, ekv)
    y, aux = _ffn_apply(cfg, descs[0], p_u, apply_norm(cfg, p_u["ln2"], x))
    cache = {"self": kv_cache, "cross_kv": ekv} if mode == "prefill" else None
    return x + y, cache, aux


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def _lookup(cfg, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding.  A table split over the model axis
    by vocab rows: each rank looks up the tokens of its block (zeros for
    the others) and the rows are summed over the model group, the one
    nonzero row exact."""
    vr = sharding.vocab_range(table.shape[0], cfg.vocab)
    if vr is None:
        return table[tokens]
    start, rows = vr
    local = tokens - start
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)]
    x = torch.where(inside[..., None], x, x.new_zeros(()))
    return sharding.reduce_from_model(x)


def _embed_tokens(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(cfg, params["embed"], tokens)
    if cfg.rope == "sincos":
        pos = sincos_embedding(tokens.shape[1], cfg.d_model, x.device)
        x = x + pos[None].to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def _embed_decode_token(cfg, params: dict, token: torch.Tensor, position: int) -> torch.Tensor:
    x = _lookup(cfg, params["embed"], token)
    if cfg.rope == "sincos":  # one sincos row at the token's position
        x = x + sincos_row(position, cfg.d_model, x.device)[None, None].to(x.dtype)
    return x.to(dtype_of(cfg.compute_dtype))


def lm_head_weights(cfg, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits of the hidden rows ``x``; a vocab-split head's blocks
    gathered over the model group in rank order, whole."""
    w = lm_head_weights(cfg, params)
    logits = (x @ w.to(x.dtype)).float()
    if sharding.vocab_range(w.shape[-1], cfg.vocab) is not None:
        logits = sharding.gather_over_model(logits, -1)
    return logits


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
    desc = SubDesc("attn", "mlp")
    for p_l in _units(params["encoder"]["blocks"], cfg.num_enc_layers):
        x, _, _ = _sublayer_fwd(cfg, desc, p_l, x, positions, "encode", None, None)
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


def backbone(cfg, params: dict, batch: Batch, mode: str = "prefill", capacity=None):
    """Embed -> units -> final norm, in ``mode`` train | prefill.  Returns
    (hidden, caches (None in train mode), aux summed over the units).  In
    train mode each unit is checkpointed when ``cfg.remat``: the backward
    keeps a unit's input and recomputes the unit."""
    descs, units = _decoder_descs(cfg)
    x = embed_fn(cfg, params, batch)
    positions = _positions_for(cfg, batch)
    enc_out = encode_frames(cfg, params, batch.frames) if cfg.enc_dec else None
    unit = functools.partial(_unit_fwd_with_cross, cfg, descs)
    if mode == "train" and cfg.remat:
        unit = functools.partial(checkpoint, unit, use_reentrant=False)
    caches, aux = [], 0.0
    for p_u in _units(params["blocks"], units):
        x, c, aux_u = unit(p_u, x, positions, mode, enc_out, capacity)
        caches.append(c)
        aux = aux + aux_u
    caches = _stack_caches(caches) if mode == "prefill" else None
    return apply_norm(cfg, params["final_norm"], x), caches, aux


def prefill(cfg, params: dict, batch: Batch, capacity=None):
    """Returns (last-token logits (B, V) float32, caches).  ``capacity``
    reserves cache room for subsequent decode steps."""
    hidden, caches, _ = backbone(cfg, params, batch, "prefill", capacity=capacity)
    return _logits(cfg, params, hidden[:, -1]), caches


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------


def chunked_xent(cfg, params: dict, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of the LM head over the labels >= 0 (-1 masks a
    position), in sequence chunks of the largest divisor of S up to
    ``chunk``: one (B, chunk, V) float32 logits tile at a time, never (B,
    S, V).  The sums and the count run in float32 chunk after chunk, as
    JAX's scan carries them.

    A head split over the model axis by vocab columns gives each rank a
    (B, chunk, V / M) tile: the log-softmax is distributed, its max over
    the model group (no gradient), then the sum of exponentials beside
    the target's logit (held by the rank whose block has it, zero
    elsewhere) in one model-group sum, all in float32."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    w = lm_head_weights(cfg, params).to(dtype_of(cfg.compute_dtype))
    vr = sharding.vocab_range(w.shape[-1], cfg.vocab)
    if vr is not None:
        hidden = sharding.copy_to_model(hidden)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        hc, lc = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        logits = (hc @ w).float()
        if vr is None:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, torch.clamp_min(lc, 0)[..., None])[..., 0]
        else:
            start, rows = vr
            m = sharding.max_over_model(torch.amax(logits, dim=-1))
            sum_exp = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
            local = lc - start
            inside = (local >= 0) & (local < rows)
            ll = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
            both = sharding.reduce_from_model(torch.stack([sum_exp, torch.where(inside, ll, 0.0)]))
            lse, ll = m + torch.log(both[0]), both[1]
        mask = (lc >= 0).float()
        tot = tot + torch.sum((lse - ll) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp_min(cnt, 1.0)


def chunked_xent_with(cfg, params_for_head: dict, hidden: torch.Tensor, labels: torch.Tensor,
                      chunk: int = 512) -> torch.Tensor:
    """:func:`chunked_xent` against the head of ``params_for_head`` (the
    outer params of the streamed step)."""
    return chunked_xent(cfg, params_for_head, hidden, labels, chunk)


def loss_fn(cfg, params: dict, batch: Batch) -> torch.Tensor:
    """The train loss: chunked cross-entropy plus ``AUX_LOSS_WEIGHT`` times
    the MoE load-balance loss."""
    hidden, _, aux = backbone(cfg, params, batch, "train")
    return chunked_xent(cfg, params, hidden, batch.labels) + AUX_LOSS_WEIGHT * aux


def outer_params(params: dict) -> dict:
    """Everything but the stacked units: embedding, head, norms, projector,
    encoder."""
    return {k: v for k, v in params.items() if k != "blocks"}


def embed_fn(cfg, outer: dict, batch: Batch) -> torch.Tensor:
    """Embedding + modality injection; returns h0 (B, S, D)."""
    x = _embed_tokens(cfg, outer, batch.tokens)
    if cfg.vlm_patches:
        x = _inject_vision(cfg, outer, x, batch.patches)
    return x


def unit_fn(cfg, unit_params: dict, h: torch.Tensor, positions: torch.Tensor):
    """One unit in train mode.  Returns (h_out, aux)."""
    descs, _ = _decoder_descs(cfg)
    h2, _, aux = _unit_fwd(cfg, descs, unit_params, h, positions, "train", None, None)
    return h2, aux


def num_sublayers(cfg) -> int:
    descs, _ = _decoder_descs(cfg)
    return len(descs)


def sublayer_fn(cfg, idx: int, sub_params: dict, h: torch.Tensor, positions: torch.Tensor):
    """Sublayer ``idx`` of a (hybrid) unit in train mode.  Returns (h_out, aux)."""
    descs, _ = _decoder_descs(cfg)
    h2, _, aux = _sublayer_fwd(cfg, descs[idx], sub_params, h, positions, "train", None, None)
    return h2, aux


def head_fn(cfg, outer: dict, hidden: torch.Tensor, batch: Batch) -> torch.Tensor:
    """Final norm + chunked cross-entropy."""
    hidden = apply_norm(cfg, outer["final_norm"], hidden)
    return chunked_xent_with(cfg, outer, hidden, batch.labels)


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
            x, new_u, _ = _unit_fwd(cfg, descs, p_u, x, None, "decode", cache_u, position)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, 0]), _with_lengths(caches, new_u)


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
