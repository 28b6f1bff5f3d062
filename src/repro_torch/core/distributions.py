"""Power-law tail and empirical density of gradient elements (paper §IV).

The port of ``repro.core.distributions``: the symmetric power-law tail
fitted from a log2-spaced |g| histogram with per-bin ln|g| sums
(``tail_from_histogram``) or from the raw tensor by the sort-based Hill fit
(``fit_power_law_tail``), and the piecewise-constant empirical density
behind the non-uniform codebooks, from a histogram or from the tensor
(``fit_empirical_density``), the truncation bias of Eq. 11
(``truncation_bias``) and a sampler with an exact power-law tail
(``sample_power_law``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .quantizers import interp, linspace

# Paper restricts gamma to (3, 5]: the bias integral needs gamma > 3 and
# empirical fits above 5 are indistinguishable from thin tails.
GAMMA_MIN = 3.05
GAMMA_MAX = 5.0
#: log-spaced bins of ``approx_abs_quantile`` over its 8 decades
QUANTILE_BINS = 512
_EPS = 1e-12


class PowerLawTail(NamedTuple):
    """Fitted symmetric power-law tail.  All fields are scalar tensors."""

    gamma: torch.Tensor   # tail index, clipped to (GAMMA_MIN, GAMMA_MAX]
    g_min: torch.Tensor   # lower bound of power-law behaviour
    rho: torch.Tensor     # one-sided tail mass P(g > g_min)
    g_max: torch.Tensor   # max |g| observed (used to clamp alpha)


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation) of a flat float32 tensor.

    A sort, then the installed JAX's ``_quantile`` arithmetic: the rank
    ``q·(n−1)`` in float32, its floor and ceiling, and the two neighbours
    weighted ``lo·(1 − w) + hi·w`` with ``w = rank − floor``.  XLA on the CPU
    contracts that sum into ``fma(hi, w, round(lo·(1 − w)))``; the product
    ``hi·w`` is exact in float64, so the sum is taken there and rounded
    once.  The rank and weights depend on n and q alone and stay on the host.
    """
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    rank = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.clip(np.floor(rank), 0, n - 1)), int(np.clip(np.ceil(rank), 0, n - 1))
    w_hi = np.float32(rank - np.floor(rank))
    w_lo = np.float32(1.0) - w_hi
    # repro: allow REPRO103 (XLA's fused multiply-add, emulated: one rounding of an exact sum)
    low = (s[lo] * float(w_lo)).to(torch.float64)
    # repro: allow REPRO103 (XLA's fused multiply-add, emulated: one rounding of an exact sum)
    return (s[hi].to(torch.float64) * float(w_hi) + low).to(torch.float32)


def histogram(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(x, bins=edges)[0]`` as float32 counts: bin i holds
    ``edges[i] <= x < edges[i+1]``, and x equal to the last edge falls in the
    last bin; values outside the edges are dropped."""
    k = edges.shape[0]
    idx = torch.searchsorted(edges, x.reshape(-1), right=True)
    idx = torch.where(x.reshape(-1) == edges[-1], k - 1, idx)
    return torch.bincount(idx, minlength=k + 1)[1:k].to(torch.float32)


def approx_abs_quantile(gabs: torch.Tensor, q: float) -> torch.Tensor:
    """Histogram-based approximate ``q``-quantile of a non-negative tensor:
    ``QUANTILE_BINS`` log-spaced bins over 8 decades below the max, interpolated
    inside the crossing bin (O(n), no sort)."""
    g_max = torch.clamp_min(torch.max(gabs), _EPS)
    lo = g_max * 1e-8
    log_lo, log_hi = torch.log(lo), torch.log(g_max)
    x = torch.clamp(torch.log(torch.maximum(gabs, lo)), log_lo, log_hi)
    edges = linspace(log_lo, log_hi, QUANTILE_BINS + 1)
    cum = torch.cat([torch.zeros(1, dtype=torch.float32, device=gabs.device),
                     torch.cumsum(histogram(x, edges), 0)])
    return torch.exp(interp(torch.tensor(q * gabs.numel(), device=gabs.device), cum, edges))


def fit_power_law_tail(
    g: torch.Tensor,
    *,
    gmin_quantile: float = 0.9,
    approx_quantile: bool = False,
) -> PowerLawTail:
    """Fit the symmetric power-law tail of ``g``'s elements: ``g_min`` is the
    ``gmin_quantile`` quantile of |g| (exact by a sort, or the histogram
    approximation with ``approx_quantile``), γ the Hill estimator over
    |g| > g_min."""
    gabs = torch.abs(g.reshape(-1)).to(torch.float32)
    g_max = torch.max(gabs)
    g_min = (approx_abs_quantile(gabs, gmin_quantile) if approx_quantile
             else quantile(gabs, gmin_quantile))
    g_min = torch.clamp_min(g_min, _EPS)
    in_tail = gabs > g_min
    n_tail = torch.sum(in_tail).to(torch.float32)
    log_ratio = torch.where(in_tail, torch.log(torch.clamp_min(gabs, _EPS) / g_min), 0.0)
    sum_log = torch.sum(log_ratio)
    gamma = torch.clamp(1.0 + n_tail / torch.clamp_min(sum_log, _EPS), GAMMA_MIN, GAMMA_MAX)
    rho = torch.clamp_min(0.5 * n_tail / n_tail.new_full((), max(gabs.numel(), 1)), _EPS)
    return PowerLawTail(gamma=gamma, g_min=g_min, rho=rho, g_max=torch.clamp_min(g_max, _EPS))


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
    # torch.take, not indexing: a 0-dim index tensor would be read on the
    # host, a device sync on the card
    g_min = torch.clamp_min(torch.minimum(torch.take(edges, idx + 1), g_max), _EPS)
    n_tail = total - torch.take(cum, idx)
    cum_log = torch.cumsum(log_sums, 0)
    sum_log = (cum_log[k - 1] - torch.take(cum_log, idx)) - n_tail * torch.log(g_min)
    gamma = torch.clamp(1.0 + n_tail / torch.clamp_min(sum_log, _EPS), GAMMA_MIN, GAMMA_MAX)
    rho = torch.clamp_min(0.5 * n_tail / torch.clamp_min(total, 1.0), _EPS)
    return PowerLawTail(gamma=gamma, g_min=g_min, rho=rho, g_max=torch.clamp_min(g_max, _EPS))


def tail_mass(tail: PowerLawTail, alpha: torch.Tensor) -> torch.Tensor:
    """One-sided mass beyond ``alpha``: rho (g_min/alpha)^(gamma-1)."""
    return tail.rho * torch.pow(tail.g_min / torch.clamp_min(alpha, _EPS), tail.gamma - 1.0)


def q_u(tail: PowerLawTail, alpha: torch.Tensor) -> torch.Tensor:
    """Q_U(alpha) = 1 - 2 * tail_mass(alpha), clipped to [eps, 1]."""
    return torch.clamp(1.0 - 2.0 * tail_mass(tail, alpha), _EPS, 1.0)


def truncation_bias(tail: PowerLawTail, alpha: torch.Tensor) -> torch.Tensor:
    """Per-element truncation bias 2·∫_α^∞ (g−α)² p(g) dg: under the
    power-law tail 4ρ g_min^(γ−1) α^(3−γ) / ((γ−2)(γ−3)), the bracketed
    factor of Eq. 11 without d/N."""
    gm, ga = tail.g_min, tail.gamma
    coeff = 4.0 * tail.rho * torch.pow(gm, ga - 1.0) / ((ga - 2.0) * (ga - 3.0))
    return coeff * torch.pow(torch.clamp_min(torch.as_tensor(alpha), _EPS), 3.0 - ga)


def sample_power_law(key: torch.Tensor, shape, *, gamma: float, g_min: float,
                     rho: float = 0.5, body_scale: float | None = None,
                     device=None) -> torch.Tensor:
    """Synthetic heavy-tailed "gradients" with an exact power-law tail.

    With probability 2ρ an element is a signed Pareto(γ−1) sample above
    g_min, otherwise uniform body mass in [−body_scale, body_scale]
    (``g_min`` by default).  The draws follow the JAX package's, key for
    key: ``k_sel, k_par, k_body, k_sign = split(key, 4)``.
    """
    k_sel, k_par, k_body, k_sign = prng.split(key, 4)
    u = prng.uniform(k_par, shape, device, minval=1e-6, maxval=1.0)
    pareto = g_min * torch.pow(u, -1.0 / (gamma - 1.0))   # inverse-CDF Pareto
    body = prng.uniform(k_body, shape, device, minval=0.0,
                        maxval=g_min if body_scale is None else body_scale)
    is_tail = prng.uniform(k_sel, shape, device) < 2.0 * rho
    mag = torch.where(is_tail, pareto, body)
    sign = torch.where(prng.bernoulli(k_sign, 0.5, shape, device), 1.0, -1.0)
    return (sign * mag).to(torch.float32)


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


def fit_empirical_density(g: torch.Tensor, *, num_bins: int = 128) -> EmpiricalDensity:
    """Histogram of |g| on ``num_bins`` equal bins over [0, max|g|], as the
    two-sided density ``counts / (2·n·width)``."""
    gabs = torch.abs(g.reshape(-1)).to(torch.float32)
    g_max = torch.clamp_min(torch.max(gabs), _EPS)
    edges = linspace(torch.zeros((), device=g.device), g_max, num_bins + 1)
    counts = histogram(gabs, edges)
    width = edges[1] - edges[0]
    n = float(max(gabs.numel(), 1))
    return EmpiricalDensity(edges=edges,
                            density=counts / (2.0 * n * torch.clamp_min(width, _EPS)))


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
