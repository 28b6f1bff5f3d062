"""Power-law tail and empirical density of gradient elements (paper §IV).

The port of the one-pass-statistics half of ``repro.core.distributions``:
the symmetric power-law tail fitted from a log2-spaced |g| histogram with
per-bin ln|g| sums (``tail_from_histogram``), and the piecewise-constant
empirical density behind the non-uniform codebook.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .quantizers import interp

# Paper restricts gamma to (3, 5]: the bias integral needs gamma > 3 and
# empirical fits above 5 are indistinguishable from thin tails.
GAMMA_MIN = 3.05
GAMMA_MAX = 5.0
_EPS = 1e-12


class PowerLawTail(NamedTuple):
    """Fitted symmetric power-law tail.  All fields are scalar tensors."""

    gamma: torch.Tensor   # tail index, clipped to (GAMMA_MIN, GAMMA_MAX]
    g_min: torch.Tensor   # lower bound of power-law behaviour
    rho: torch.Tensor     # one-sided tail mass P(g > g_min)
    g_max: torch.Tensor   # max |g| observed (used to clamp alpha)


def tail_from_histogram(
    counts: torch.Tensor,
    log_sums: torch.Tensor,
    g_max: torch.Tensor,
    edges: torch.Tensor,
    *,
    gmin_quantile: float = 0.9,
) -> PowerLawTail:
    """Power-law tail fit from a |g| histogram plus per-bin ln|g| sums.

    ``g_min`` snaps to the upper edge of the bin where the |g| CDF crosses
    ``gmin_quantile``; the Hill estimator runs over the whole bins above it.
    """
    k = counts.shape[0]
    total = torch.sum(counts)
    cum = torch.cumsum(counts, 0)
    idx = torch.clamp(torch.searchsorted(cum, (gmin_quantile * total).reshape(1)), 0, k - 1)[0]
    g_min = torch.clamp_min(torch.minimum(edges[idx + 1], g_max), _EPS)
    n_tail = total - cum[idx]
    cum_log = torch.cumsum(log_sums, 0)
    sum_log = (cum_log[k - 1] - cum_log[idx]) - n_tail * torch.log(g_min)
    gamma = torch.clamp(1.0 + n_tail / torch.clamp_min(sum_log, _EPS), GAMMA_MIN, GAMMA_MAX)
    rho = torch.clamp_min(0.5 * n_tail / torch.clamp_min(total, 1.0), _EPS)
    return PowerLawTail(gamma=gamma, g_min=g_min, rho=rho, g_max=torch.clamp_min(g_max, _EPS))


def tail_mass(tail: PowerLawTail, alpha: torch.Tensor) -> torch.Tensor:
    """One-sided mass beyond ``alpha``: rho (g_min/alpha)^(gamma-1)."""
    return tail.rho * torch.pow(tail.g_min / torch.clamp_min(alpha, _EPS), tail.gamma - 1.0)


def q_u(tail: PowerLawTail, alpha: torch.Tensor) -> torch.Tensor:
    """Q_U(alpha) = 1 - 2 * tail_mass(alpha), clipped to [eps, 1]."""
    return torch.clamp(1.0 - 2.0 * tail_mass(tail, alpha), _EPS, 1.0)


@dataclasses.dataclass(frozen=True)
class EmpiricalDensity:
    """Piecewise-constant symmetric density estimate of gradient elements:
    ``density[k]`` is the two-sided density on |g| bin [edges[k], edges[k+1])."""

    edges: torch.Tensor    # (K+1,) bin edges over |g|, edges[0] = 0
    density: torch.Tensor  # (K,) two-sided density value on each bin

    @property
    def num_bins(self) -> int:
        return self.density.shape[0]


def density_from_histogram(counts: torch.Tensor, edges: torch.Tensor) -> EmpiricalDensity:
    """Piecewise-constant two-sided density from a |g| histogram."""
    widths = torch.clamp_min(edges[1:] - edges[:-1], _EPS)
    total = torch.clamp_min(torch.sum(counts), 1.0)
    return EmpiricalDensity(edges=edges, density=counts / (2.0 * total * widths))


def _cum_integral(dens: EmpiricalDensity, values: torch.Tensor) -> torch.Tensor:
    """Edges-aligned cumulative integral of a per-bin integrand:
    C[0] = 0, C[k] = int_0^{edges[k]} integrand."""
    widths = dens.edges[1:] - dens.edges[:-1]
    return torch.cat([torch.zeros(1, dtype=values.dtype, device=values.device),
                      torch.cumsum(values * widths, 0)])


def cum_p(dens: EmpiricalDensity) -> torch.Tensor:
    """C_p aligned to edges: int_0^x p(g) dg (one-sided)."""
    return _cum_integral(dens, dens.density)


def cum_p_third(dens: EmpiricalDensity) -> torch.Tensor:
    """C_{p^(1/3)} aligned to edges: int_0^x p(g)^(1/3) dg (one-sided)."""
    return _cum_integral(dens, torch.pow(torch.clamp_min(dens.density, 0.0), 1.0 / 3.0))


def interp_cum(cum: torch.Tensor, dens: EmpiricalDensity, x: torch.Tensor) -> torch.Tensor:
    """Evaluate an edges-aligned cumulative integral at arbitrary |g| = x."""
    return interp(x, dens.edges, cum)
