"""Mamba2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

The port of ``repro.models.ssm``.  Prefill uses the chunkwise form: the
quadratic attention-like product inside chunks of length Q, a linear
recurrence over chunk summaries and a state->output correction, one chunk
at a time in a Python loop where JAX scans.  Decode is the O(1) recurrent
step.  The SSD math runs in float32 whatever the compute dtype, as the JAX
package's does; the B/C products are taken per group and broadcast over
the group's heads (the same sums; JAX repeats B and C over the heads
first).

Projections are kept separate (wz/wx/wB/wC/wdt) instead of Mamba's fused
in_proj.  The short causal conv is depthwise and applied per stream.

States are written in place: :func:`ssm_decode` stores the new conv tails
and recurrent state into the ``SSMState`` it is given and returns it, as
``attention.attention_decode`` does with a KV cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.quantizers import linspace

from .layers import dense_init, dtype_of, rmsnorm

NEG_INF = -1e30


class SSMState(NamedTuple):
    conv_x: torch.Tensor   # ([U,] B, W-1, d_inner) raw pre-conv inputs
    conv_B: torch.Tensor   # ([U,] B, W-1, G*N)
    conv_C: torch.Tensor   # ([U,] B, W-1, G*N)
    ssm: torch.Tensor      # ([U,] B, H, P, N) recurrent state


def ssm_dims(cfg) -> tuple[int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def ssm_axes() -> dict:
    """The logical axes of :func:`ssm_init`'s leaves (JAX's ``ssm_init``'s
    second result)."""
    return {"wz": ("embed_fsdp", "ff"), "wx": ("embed_fsdp", "ff"),
            "wB": ("embed_fsdp", None), "wC": ("embed_fsdp", None), "wdt": ("embed", None),
            "conv_x": (None, "ff"), "conv_B": (None, None), "conv_C": (None, None),
            "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm": ("ff",),
            "wo": ("ff", "embed_fsdp")}


def ssm_init(key: torch.Tensor, cfg, d: int, device) -> dict:
    """JAX's ``split(key, 10)`` draws, key for key: ``ks[7]`` for ``dt``,
    ``ks[6]``/``ks[8]`` for ``conv_B``/``conv_C``, ``ks[9]`` for ``wo``."""
    s = cfg.ssm
    di, h = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    ks = prng.split(key, 10)
    dtype = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    # dt bias: inverse-softplus of dt ~ U[1e-3, 1e-1] (mamba2 init)
    lo, hi = torch.log(torch.tensor(1e-3, dtype=f32)), torch.log(torch.tensor(0.1, dtype=f32))
    dt = torch.exp(prng.uniform(ks[7], (h,)) * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    w = s.conv_width
    return {
        "wz": dense_init(ks[0], (d, di), d, dtype, device),
        "wx": dense_init(ks[1], (d, di), d, dtype, device),
        "wB": dense_init(ks[2], (d, gn), d, dtype, device),
        "wC": dense_init(ks[3], (d, gn), d, dtype, device),
        "wdt": dense_init(ks[4], (d, h), d, f32, device),
        "conv_x": dense_init(ks[5], (w, di), w, f32, device),
        "conv_B": dense_init(ks[6], (w, gn), w, f32, device),
        "conv_C": dense_init(ks[8], (w, gn), w, f32, device),
        "A_log": torch.log(linspace(1.0, 16.0, h)).to(device),
        "D": torch.ones(h, dtype=f32, device=device),
        "dt_bias": dt_bias.to(device),
        "norm": torch.ones(di, dtype=f32, device=device),
        "wo": dense_init(ks[9], (di, d), di, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, C), w: (W, C).  ``tail``: (B, W-1, C)
    carried context from a previous segment.

    The taps (inputs and weights in x's dtype) are added in float32 and the
    sum rounded to x's dtype once, as the decode step's ``einsum`` over the
    window rounds it: a bfloat16 prefill and decode then give a position
    the same conv output (in float32 this is JAX's op sequence)."""
    width, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1).float()
    out = xp.new_zeros((x.shape[0], s, x.shape[2]))
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype).float()
    return out.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> (..., Q, Q) lower-triangular segment sums."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, ss, NEG_INF)


def ssd_chunked(x: torch.Tensor, log_decay: torch.Tensor, b_s: torch.Tensor, c_s: torch.Tensor,
                chunk: int, init_state: torch.Tensor | None = None):
    """x: (B, S, H, P), already multiplied by dt; log_decay: (B, S, H) =
    dt * A (negative); b_s, c_s: (B, S, G, N); init_state: (B, H, P, N).

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    The chunk is ``min(chunk, S)`` lowered to a divisor of S; each chunk
    does the intra-chunk quadratic (one (B, H, Q, Q) tile), the
    state->output correction against the carried state and the state
    update."""
    bsz, s, h, p = x.shape
    g, n = b_s.shape[2], b_s.shape[3]
    q = min(chunk, s)
    while s % q:
        q -= 1
    hpg = h // g
    state = (x.new_zeros((bsz, h, p, n), dtype=torch.float32) if init_state is None
             else init_state.float())
    ys = []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        xf = x[:, sl].float()                                      # (B,Q,H,P)
        bg = b_s[:, sl].float()                                    # (B,Q,G,N)
        cg = c_s[:, sl].float()
        a_c = log_decay[:, sl].float().transpose(1, 2)             # (B,H,Q)
        a_cum = torch.cumsum(a_c, dim=-1)
        # intra-chunk quadratic: C·B per group, broadcast over its heads
        scores = torch.einsum("bqgn,bkgn->bgqk", cg, bg)
        scores = scores.repeat_interleave(hpg, dim=1)              # (B,H,Q,K)
        w = scores * torch.exp(_segsum(a_c))
        y = (w @ xf.transpose(1, 2)).transpose(1, 2)               # (B,Q,H,P)
        # carried-state contribution
        st = state.reshape(bsz, g, hpg, p, n)
        y_off = torch.einsum("bqgn,bgjpn->bqgjp", cg, st).reshape(bsz, q, h, p)
        y = y + y_off * torch.exp(a_cum).transpose(1, 2)[..., None]
        # state update
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)           # (B,H,Q)
        xd = (xf * decay_states.transpose(1, 2)[..., None]).reshape(bsz, q, g, hpg, p)
        summary = torch.einsum("bkgn,bkgjp->bgjpn", bg, xd).reshape(bsz, h, p, n)
        state = state * torch.exp(a_cum[..., -1])[..., None, None] + summary
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), state


def _ssd_inputs(p: dict, x: torch.Tensor):
    """dt (float32, softplus of the projection plus its bias) and A."""
    dt = F.softplus((x.float() @ p["wdt"]) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def ssm_forward(cfg, p: dict, x: torch.Tensor, state: SSMState | None = None, *,
                return_state: bool = False):
    """Full-sequence SSD pass (prefill).  x: (B, S, D).  With
    ``return_state`` also returns the ``SSMState`` after the sequence (its
    conv tails float32)."""
    s_cfg = cfg.ssm
    di, h = ssm_dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.d_state
    bsz, s = x.shape[:2]

    z = x @ p["wz"]
    xs_raw, bs_raw, cs_raw = x @ p["wx"], x @ p["wB"], x @ p["wC"]
    tails = (None,) * 3 if state is None else (state.conv_x, state.conv_B, state.conv_C)
    xs = F.silu(_causal_conv(xs_raw, p["conv_x"], tails[0]))
    bs = F.silu(_causal_conv(bs_raw, p["conv_B"], tails[1]))
    cs = F.silu(_causal_conv(cs_raw, p["conv_C"], tails[2]))

    dt, a = _ssd_inputs(p, x)                                    # (B,S,H), (H,)
    xh = xs.reshape(bsz, s, h, s_cfg.head_dim)
    y, fin = ssd_chunked(xh.float() * dt[..., None], dt * a, bs.reshape(bsz, s, g, n),
                         cs.reshape(bsz, s, g, n), s_cfg.chunk,
                         init_state=None if state is None else state.ssm)
    y = y + xh.float() * p["D"][:, None]
    y = rmsnorm(y.reshape(bsz, s, di).to(x.dtype) * F.silu(z), p["norm"])
    out = y @ p["wo"]
    if not return_state:
        return out
    w = s_cfg.conv_width
    return out, SSMState(conv_x=xs_raw[:, -(w - 1):].float(),
                         conv_B=bs_raw[:, -(w - 1):].float(),
                         conv_C=cs_raw[:, -(w - 1):].float(), ssm=fin)


def ssm_decode(cfg, p: dict, x: torch.Tensor, state: SSMState):
    """Single-token recurrent step.  x: (B, 1, D).  Writes the new conv
    tails and recurrent state into ``state`` and returns (y, state)."""
    s_cfg = cfg.ssm
    di, h = ssm_dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.d_state
    bsz = x.shape[0]

    z = x @ p["wz"]

    def step_conv(tail, new, wgt):
        ctx = torch.cat([tail.to(new.dtype), new], dim=1)                # (B, W, C)
        out = torch.einsum("bwc,wc->bc", ctx, wgt.to(new.dtype))[:, None]
        tail.copy_(ctx[:, 1:])
        return F.silu(out)

    xs = step_conv(state.conv_x, x @ p["wx"], p["conv_x"])
    bs = step_conv(state.conv_B, x @ p["wB"], p["conv_B"])
    cs = step_conv(state.conv_C, x @ p["wC"], p["conv_C"])

    dt, a = _ssd_inputs(p, x)
    dt = dt[:, 0]                                                          # (B,H)
    xh = xs.reshape(bsz, h, s_cfg.head_dim).float()
    bh = bs.reshape(bsz, g, n).repeat_interleave(h // g, dim=1).float()   # (B,H,N)
    chh = cs.reshape(bsz, g, n).repeat_interleave(h // g, dim=1).float()
    hs = state.ssm.float() * torch.exp(dt * a)[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh * dt[..., None], bh)
    state.ssm.copy_(hs)
    y = torch.einsum("bhpn,bhn->bhp", hs, chh) + xh * p["D"][:, None]
    y = rmsnorm(y.reshape(bsz, 1, di).to(x.dtype) * F.silu(z), p["norm"])
    return y @ p["wo"], state


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device="cuda") -> SSMState:
    s = cfg.ssm
    di, h = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    w = s.conv_width

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SSMState(conv_x=zeros(batch, w - 1, di), conv_B=zeros(batch, w - 1, gn),
                    conv_C=zeros(batch, w - 1, gn), ssm=zeros(batch, h, s.head_dim, s.d_state))


def naive_recurrence(x: torch.Tensor, log_decay: torch.Tensor, b_s: torch.Tensor,
                     c_s: torch.Tensor) -> torch.Tensor:
    """O(S) reference recurrence for testing :func:`ssd_chunked`; shapes
    as there.  Returns y (B, S, H, P) float32."""
    bsz, s, h, p = x.shape
    n = b_s.shape[3]
    hpg = h // b_s.shape[2]
    bh = b_s.repeat_interleave(hpg, dim=2).float()
    ch = c_s.repeat_interleave(hpg, dim=2).float()
    hstate = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        hstate = hstate * torch.exp(log_decay[:, t].float())[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t].float(), bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, ch[:, t]))
    return torch.stack(ys, dim=1)
