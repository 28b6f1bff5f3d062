"""Optimal truncation threshold α and codebooks (paper §IV), PyTorch port.

- TQSGD  (uniform):     α fixed-point of Eq. 12 with Q_U(α);
- TNQSGD (non-uniform): λ ∝ p^(1/3) (Eq. 18), α fixed-point of Eq. 19 with Q_N;
- TBQSGD (bi-scaled):   piecewise-uniform λ (Eq. 25/34), k* by grid search,
  α fixed-point of Eq. 33 with Q_B.

The solvers run a fixed number of fixed-point iterations and clamp α into
[g_min, g_max].
"""
from __future__ import annotations

import torch

from .distributions import EmpiricalDensity, PowerLawTail, cum_p, cum_p_third, interp_cum, q_u
from .quantizers import interp, levels_from_density, linspace, num_levels, uniform_levels

_EPS = 1e-12
#: split points k of the bi-scaled grid search, evenly over [0.02, 0.98]
K_GRID = 49


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


def q_b(dens: EmpiricalDensity, alpha: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Q_B(α, k) of Appendix D, elementwise over a tensor of split points k:
    [ (2∫_{kα}^{α} p)^{1/3} (1-k)^{2/3} + (2∫_0^{kα} p)^{1/3} k^{2/3} ]^3."""
    cp = cum_p(dens)
    at_k = interp_cum(cp, dens, k * alpha)
    inner = torch.clamp_min(2.0 * at_k, 0.0)
    outer = torch.clamp_min(2.0 * (interp_cum(cp, dens, alpha) - at_k), 0.0)
    term = (torch.pow(outer, 1 / 3) * torch.pow(1.0 - k, 2 / 3)
            + torch.pow(inner, 1 / 3) * torch.pow(k, 2 / 3))
    return torch.pow(term, 3.0)


def solve_biscaled(tail: PowerLawTail, dens: EmpiricalDensity, bits: int, *,
                   iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """k* = argmin_k Q_B(α, k) over ``K_GRID`` split points in [0.02, 0.98],
    evaluated as one batch, and α from Eq. 33 iterated.  Returns (alpha,
    k_star)."""
    zero = torch.zeros((), dtype=torch.float32, device=tail.g_min.device)
    ks = linspace(zero + 0.02, zero + 0.98, K_GRID)

    def q_best(alpha):
        return torch.clamp(torch.min(q_b(dens, alpha, ks)), _EPS, 1.0)

    alpha = _alpha_fixed_point(tail, num_levels(bits), q_best, iters)
    return alpha, torch.take(ks, torch.argmin(q_b(dens, alpha, ks)))


def biscaled_codebook(dens: EmpiricalDensity, alpha: torch.Tensor, k: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """Piecewise-uniform codebook per Eq. 34: one density on |g| < kα and
    another on kα <= |g| <= α, split by the cube-root rule (Eq. 29/30)."""
    cp = cum_p(dens)
    beta = k * alpha
    at_beta = interp_cum(cp, dens, beta)
    mass_in = 2.0 * at_beta
    mass_out = 2.0 * (interp_cum(cp, dens, alpha) - at_beta)
    p1 = torch.clamp_min(mass_in, _EPS) / torch.clamp_min(2.0 * beta, _EPS)
    p2 = torch.clamp_min(mass_out, _EPS) / torch.clamp_min(2.0 * (alpha - beta), _EPS)
    lam_in, lam_out = torch.pow(p1, 1 / 3), torch.pow(p2, 1 / 3)
    zero = torch.zeros((), dtype=torch.float32, device=alpha.device)
    edges = linspace(zero, zero + 1.0, dens.num_bins + 1) * alpha
    centers = 0.5 * (edges[:-1] + edges[1:])
    lam = torch.where(centers < beta, lam_in, lam_out)
    lam = torch.maximum(lam, 1e-6 * torch.maximum(lam_in, lam_out))
    return levels_from_density(edges, lam, bits)
