"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro.models.moe``.  Tokens are routed by sorting their
(token, expert) assignments by expert id (a stable sort), ranking each
within its expert, dropping those beyond capacity and gathering the rest
into a dense (E, C, D) buffer that feeds a batched expert matmul.  The
JAX package shards the buffer's expert axis over 'model'; here one device
holds every expert, and the expert parallelism comes with the port's
sharding rules.

Two places where the card could part from the reference:

- **Top-k ties.**  ``lax.top_k`` breaks ties toward the lower expert id;
  ``torch.topk`` promises no order.  :func:`_route` takes the first k of a
  stable descending sort instead.
- **The combine.**  JAX scatter-adds the gated slot outputs into a zeros
  tensor in ``param_dtype``, in slot order (XLA applies a scatter's updates
  in order).  ``index_add_`` on the card adds in an unfixed order, which
  changes the result of a top-8 sum from run to run.  :func:`_combine`
  gathers each token's k slot outputs and adds them one by one from zeros
  in ascending slot order, which is ascending expert id: no atomics.

``dense_moe_apply`` (every expert on every token) is the reference path
for small sizes; ``transformer._ffn_apply`` switches to it as JAX does.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng

from .layers import dense_init, dtype_of, mlp_apply

GROUP_TOKENS = 16384  # dispatch group size: bounds the (T*k, D) gather temps


def moe_init(key: torch.Tensor, cfg, d: int, device) -> dict:
    """Router (d, e) in float32; experts ``wi``/``wg`` (e, d, f) and ``wo``
    (e, f, d) in ``param_dtype``; keys ``split(key, 4)`` in that order."""
    m = cfg.moe
    f = m.d_ff or cfg.d_ff
    e = m.num_experts
    ks = prng.split(key, 4)
    dtype = dtype_of(cfg.param_dtype)
    return {"router": dense_init(ks[0], (d, e), d, torch.float32, device),
            "wi": dense_init(ks[1], (e, d, f), d, dtype, device),
            "wg": dense_init(ks[2], (e, d, f), d, dtype, device),
            "wo": dense_init(ks[3], (e, f, d), f, dtype, device)}


def moe_axes() -> dict:
    """The logical axes of :func:`moe_init`'s leaves (JAX's ``moe_init``'s
    second result)."""
    return {"router": ("embed", "expert"), "wi": ("expert", "embed_fsdp", "ff"),
            "wg": ("expert", "embed_fsdp", "ff"), "wo": ("expert", "ff", "embed_fsdp")}


def _route(cfg, p: dict, xf: torch.Tensor):
    """xf: (T, D) -> (gates (T, k), expert ids (T, k), router probs (T, E)).

    The top k are the first k of a stable descending sort: equal
    probabilities keep the lower expert id first, as ``lax.top_k``."""
    k = cfg.moe.top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, idx, probs


def _aux_loss(e: int, idx: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch-style load balance: E * <fraction routed first> . <router prob>.
    The counts are an integer scatter-add (exact in any order), which the
    meta device runs too (``launch.dryrun``)."""
    first = idx[:, 0]
    counts = torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
        0, first, torch.ones_like(first))
    me = counts.float() / idx.shape[0]
    return e * torch.sum(me * probs.mean(0))


def capacity(cfg, tokens: int) -> int:
    m = cfg.moe
    c = int(m.top_k * tokens * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def moe_apply(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D).  Returns (y, aux_loss).

    Tokens go in groups of ``GROUP_TOKENS`` (the largest divisor of the
    token count at most that), one after another where JAX scans, and
    capacity applies per group; ``aux`` is the mean over groups.  Under
    autograd each group is checkpointed.  The gate gradients flow through
    the gathered router probabilities; the expert ids take none."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    g = GROUP_TOKENS
    if t <= g:
        y, aux = _moe_group(cfg, p, xf)
        return y.reshape(*lead, d).to(x.dtype), aux
    while t % g:
        g -= 1
    group = _moe_group
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in p.values())):
        # checkpoint each group, as JAX does: the backward keeps a group's
        # input, not its gathered tokens and expert buffer
        group = functools.partial(checkpoint, _moe_group, use_reentrant=False)
    ys, auxs = zip(*(group(cfg, p, xf[i:i + g]) for i in range(0, t, g)))
    return torch.cat(ys).reshape(*lead, d).to(x.dtype), torch.stack(auxs).mean()


def _dispatch(cfg, idx: torch.Tensor, gates: torch.Tensor, c: int):
    """The sort-based plan of one group.  Returns the kept mask and slot of
    each assignment in expert-sorted (stable) order (dropped -> the dump
    row ``e * c``), that order, and the slot tables (``slot_tok``,
    ``slot_valid``, ``slot_gate``; ``e * c + 1`` rows)."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    dev = idx.device
    e_flat = idx.reshape(-1)                            # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = order // k                             # repeat(arange(T), k)[order]
    g_sorted = gates.reshape(-1)[order]
    # rank within expert = index - start offset of that expert's run
    starts = torch.searchsorted(e_sorted, torch.arange(e, device=dev), side="left")
    rank = torch.arange(e_flat.numel(), device=dev) - starts[e_sorted]
    keep = rank < c
    slot = torch.where(keep, e_sorted * c + rank, e * c)
    # only the dump row takes more than one write; it is never read
    slot_tok = torch.zeros(e * c + 1, dtype=torch.int64, device=dev)
    slot_tok[slot] = tok_sorted
    slot_valid = torch.zeros(e * c + 1, dtype=torch.bool, device=dev)
    slot_valid[slot] = keep
    slot_gate = torch.zeros(e * c + 1, dtype=torch.float32, device=dev)
    slot_gate[slot] = g_sorted * keep
    return keep, slot, order, slot_tok, slot_valid, slot_gate


def _combine(out_flat: torch.Tensor, slot: torch.Tensor, order: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """Each token's gated slot outputs added one by one from zeros in
    ascending slot order (XLA's scatter-add order), dropped ones as zeros.
    out_flat: (E*C, D), already gated."""
    d = out_flat.shape[1]
    rows = torch.cat([out_flat, out_flat.new_zeros(1, d)])   # row E*C: the dump
    tok_slot = torch.empty_like(slot)
    tok_slot[order] = slot                                   # (T*k,) in token-major order
    tok_slot, _ = torch.sort(tok_slot.reshape(t, k), dim=1)
    parts = rows[tok_slot]                                   # (T, k, D)
    y = out_flat.new_zeros(t, d)
    for j in range(k):
        y = y + parts[:, j]
    return y


def _moe_group(cfg, p: dict, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch for one token group.  xf: (T, D)."""
    t, d = xf.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    c = capacity(cfg, t)
    gates, idx, probs = _route(cfg, p, xf)
    aux = _aux_loss(e, idx, probs)
    _, slot, order, slot_tok, slot_valid, slot_gate = _dispatch(cfg, idx, gates, c)
    buf = xf[slot_tok[:e * c]] * slot_valid[:e * c, None].to(xf.dtype)
    out = mlp_apply(cfg, p, buf.reshape(e, c, d))      # the experts' batched FFN
    out_flat = out.reshape(e * c, d) * slot_gate[:e * c, None].to(out.dtype)
    return _combine(out_flat, slot, order, t, k), aux


def dense_moe_apply(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference: every expert on every token, masked by top-k gates."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    gates, idx, probs = _route(cfg, p, xf)
    e = cfg.moe.num_experts
    h = torch.einsum("td,edf->tef", xf, p["wi"])
    if cfg.act in ("silu", "gelu"):
        act = F.silu if cfg.act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))
        h = act(h) * torch.einsum("td,edf->tef", xf, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("tef,efd->ted", h, p["wo"])            # (T, E, D)
    w = out.new_zeros(xf.shape[0], e).scatter_(1, idx, gates.to(out.dtype))  # ids distinct
    y = torch.einsum("ted,te->td", out, w)
    return y.reshape(*lead, d).to(x.dtype), _aux_loss(e, idx, probs)
