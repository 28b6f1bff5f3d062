"""Optimal truncation threshold α and codebooks (paper §IV), PyTorch port.

- TQSGD  (uniform):     α fixed-point of Eq. 12 with Q_U(α);
- TNQSGD (non-uniform): λ ∝ p^(1/3) (Eq. 18), α fixed-point of Eq. 19 with Q_N.

The solvers run a fixed number of fixed-point iterations and clamp α into
[g_min, g_max].  The bi-scaled TBQSGD solver is still to port (ROADMAP
Queue 1 item 1).
"""
from __future__ import annotations

import torch

from .distributions import EmpiricalDensity, PowerLawTail, cum_p_third, interp_cum, q_u
from .quantizers import interp, levels_from_density, linspace, num_levels, uniform_levels

_EPS = 1e-12


def _alpha_fixed_point(tail: PowerLawTail, s: int, q_fn, iters: int) -> torch.Tensor:
    """α ← g_min · [2ρs²/((γ-2)·Q(α))]^{1/(γ-1)}, from Q = 1."""
    gamma, g_min, rho = tail.gamma, tail.g_min, tail.rho
    expo = 1.0 / (gamma - 1.0)
    num, gm2 = 2.0 * rho * s * s, gamma - 2.0

    def base(q):
        return g_min * torch.pow(num / (gm2 * torch.clamp_min(q, _EPS)), expo)

    alpha = base(torch.ones((), dtype=torch.float32, device=g_min.device))
    for _ in range(iters):
        alpha = base(q_fn(torch.clamp(alpha, tail.g_min, tail.g_max)))
    return torch.clamp(alpha, tail.g_min, tail.g_max)


def solve_alpha_uniform(tail: PowerLawTail, bits: int, *, iters: int = 10) -> torch.Tensor:
    """Optimal α for the truncated *uniform* quantizer (Eq. 12)."""
    return _alpha_fixed_point(tail, num_levels(bits), lambda a: q_u(tail, a), iters)


def uniform_codebook(alpha: torch.Tensor, bits: int) -> torch.Tensor:
    return uniform_levels(alpha, bits).to(torch.float32)


def q_n(dens: EmpiricalDensity, alpha: torch.Tensor) -> torch.Tensor:
    """Q_N(α) = [ ∫_{-α}^{α} p^(1/3) (1/2α)^(2/3) dg ]^3  (Eq. 19)."""
    full = 2.0 * interp_cum(cum_p_third(dens), dens, alpha)
    return torch.pow(full, 3.0) / torch.clamp_min((2.0 * alpha) ** 2, _EPS)


def solve_alpha_nonuniform(
    tail: PowerLawTail, dens: EmpiricalDensity, bits: int, *, iters: int = 10
) -> torch.Tensor:
    """Optimal α for the non-uniform quantizer (Eq. 19 fixed point)."""
    return _alpha_fixed_point(
        tail, num_levels(bits), lambda a: torch.clamp(q_n(dens, a), _EPS, 1.0), iters)


def nonuniform_codebook(dens: EmpiricalDensity, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """Codebook with λ ∝ p^(1/3) on [-α, α] (Eq. 18): the density is
    interpolated onto a fresh |g| grid over [0, α] with the same bin count."""
    zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
    edges = linspace(zero, zero + 1.0, dens.num_bins + 1) * alpha
    centers = 0.5 * (edges[:-1] + edges[1:])
    centers_src = 0.5 * (dens.edges[:-1] + dens.edges[1:])
    p = interp(centers, centers_src, dens.density)
    lam = torch.pow(torch.clamp_min(p, 0.0), 1.0 / 3.0)
    # Give empty bins a tiny floor so levels stay strictly increasing.
    lam = torch.maximum(lam, 1e-6 * torch.max(lam))
    return levels_from_density(edges, lam, bits)
