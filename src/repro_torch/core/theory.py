"""Closed-form error expressions of the paper, PyTorch port of
``repro.core.theory``.

Eq. (11), (15) and the theorem bounds, per element: the paper's E_TQ
carries a d/N factor, the same for every scheme, which is dropped here.
The adaptive controller scores bit widths with them, and the benchmarks
compare measured quantization errors against them.
"""
from __future__ import annotations

import torch

from .distributions import (EmpiricalDensity, PowerLawTail, cum_p, interp_cum, q_u,
                            truncation_bias)
from .optimal import q_b, q_n
from .quantizers import num_levels

_EPS = 1e-12


def quant_variance_uniform(tail: PowerLawTail, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """First term of Eq. 11: ``Q_U(α) α² / s²`` (the (1/4)∫p/λ² of the
    uniform quantizer at λ = s/2α)."""
    s = num_levels(bits)
    return q_u(tail, alpha) * alpha**2 / s**2


def quant_variance_density(dens: EmpiricalDensity, levels: torch.Tensor) -> torch.Tensor:
    """(1/4) Σ_k P_k |Δ_k|² (the bound of Lemma 1) for any codebook, with
    the interval masses P_k under the symmetric empirical density."""
    cp = cum_p(dens)

    def one_sided(x):
        return torch.sign(x) * interp_cum(cp, dens, torch.abs(x))

    lo, hi = levels[:-1], levels[1:]
    pk = one_sided(hi) - one_sided(lo)
    return 0.25 * torch.sum(torch.clamp_min(pk, 0.0) * (hi - lo) ** 2)


def e_tq_uniform(tail: PowerLawTail, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-element E_TQ of the truncated uniform quantizer (Eq. 11 without d/N)."""
    return quant_variance_uniform(tail, alpha, bits) + truncation_bias(tail, alpha)


def e_tq_nonuniform(tail: PowerLawTail, dens: EmpiricalDensity, alpha: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Per-element E_TQ of the truncated non-uniform quantizer: the
    ``Q_N(α) α²/s²`` variance (Eq. 15 with λ ∝ p^(1/3)) plus the power-law
    truncation bias of Eq. 11."""
    s = num_levels(bits)
    return q_n(dens, alpha) * alpha**2 / s**2 + truncation_bias(tail, alpha)


def e_tq_bound(tail: PowerLawTail, q_value: torch.Tensor, bits: int) -> torch.Tensor:
    """The master bound of Theorems 1–3 (per element, without d/N)::

        (γ-1) Q^{(γ-3)/(γ-1)} · g_min² (2ρ)^{2/(γ-1)} s^{(6-2γ)/(γ-1)}
        / ((γ-3)(γ-2)^{2/(γ-1)})

    with Q = Q_U, Q_N or Q_B for TQSGD, TNQSGD and TBQSGD.
    """
    s = num_levels(bits)
    ga, gm, rho = tail.gamma, tail.g_min, tail.rho
    num = (ga - 1.0) * torch.pow(q_value, (ga - 3.0) / (ga - 1.0))
    s32 = torch.tensor(float(s), dtype=torch.float32, device=ga.device)
    num = (num * gm**2 * torch.pow(2.0 * rho, 2.0 / (ga - 1.0))
           * torch.pow(s32, (6.0 - 2.0 * ga) / (ga - 1.0)))
    den = (ga - 3.0) * torch.pow(ga - 2.0, 2.0 / (ga - 1.0))
    return num / torch.clamp_min(den, _EPS)


def holder_chain(tail: PowerLawTail, dens: EmpiricalDensity, alpha: torch.Tensor,
                 k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Q_N, Q_B, Q_U) at one α: the paper's Hölder ordering
    Q_N ≤ Q_B ≤ Q_U."""
    return q_n(dens, alpha), q_b(dens, alpha, k), q_u(tail, alpha)


def dsgd_error(f0_minus_fstar: float, eta: float, T: int, sigma2: float, n_clients: int,
               batch: int) -> float:
    """E_DSGD of Eq. 7: 2ΔF/(Tη) + σ²/(NB)."""
    return 2.0 * f0_minus_fstar / (T * eta) + sigma2 / (n_clients * batch)
