"""Executable form of the paper's convergence theory (Theorem 1, Lemmas
2–4) (repro/core/theory.py; numpy only).

  α  = |λ̂₂| / (1 − |λ̂₂|),        λ̂₂ = λ₂(E[WWᵀ])          (Lemma 3)
  γ  = max{8 L/μ − 1, H}                                     (stepsize feas.)
  B  = (4/K + 8) α H G² + 6 L Γ + σ̄²/n                       (Theorem 1)
  E[f(z̄^t)] − f(z*) ≤ L/(γ+t) · (2B/μ² + (γ+1)/2 ‖z¹−z*‖²)

and the paper's stepsize schedule η_t = 2/(μ(γ+t)).  For FedAvg the
comparable bound (Li et al. [16]) carries C = O(H²) G² in place of
(4/K+8) α H G² (:func:`fedavg_bound_constant`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "alpha", "gamma", "bound_constant_B", "convergence_bound",
    "paper_stepsize", "fedavg_bound_constant",
    "TheoremInputs", "theorem1_curve",
]


def alpha(lambda2_hat: float) -> float:
    """α = |λ̂₂|/(1 − |λ̂₂|) — vanishes as the network gets more connected."""
    if not 0.0 <= lambda2_hat < 1.0:
        raise ValueError(f"|λ̂₂| must be in [0,1), got {lambda2_hat}")
    return lambda2_hat / (1.0 - lambda2_hat)


def gamma(l_smooth: float, mu: float, h: int) -> float:
    """γ = max{8L/μ − 1, H} — makes η_t ≤ 1/(4L) and η_t ≤ 2η_{t+H} hold."""
    return max(8.0 * l_smooth / mu - 1.0, float(h))


def bound_constant_B(*, k: int, alpha_val: float, h: int, g2: float,
                     l_smooth: float, gamma_heterogeneity: float,
                     sigma_bar2: float, n: int) -> float:
    """B = (4/K + 8) α H G² + 6 L Γ + σ̄²/n  (Theorem 1): O(H), not H²."""
    return ((4.0 / k + 8.0) * alpha_val * h * g2
            + 6.0 * l_smooth * gamma_heterogeneity
            + sigma_bar2 / n)


def fedavg_bound_constant(*, k: int, h: int, g2: float, l_smooth: float,
                          gamma_heterogeneity: float, sigma_bar2: float,
                          n: int) -> float:
    """FedAvg counterpart (Li et al. [16]): the H term is O(H²) G².

    C = (4/K + 8) H² G² + 6 L Γ + σ̄²/n — the same structure with α H → H²
    (the paper's normalisation, so the two curves compare directly).
    """
    return ((4.0 / k + 8.0) * float(h) ** 2 * g2
            + 6.0 * l_smooth * gamma_heterogeneity
            + sigma_bar2 / n)


def paper_stepsize(mu: float, gamma_val):
    """η_t = 2/(μ(γ+t)) — the diminishing schedule of Theorem 1 (t from 1),
    as plain numbers (optim/schedules.py:paper_diminishing gives tensors)."""
    def lr_fn(t):
        return 2.0 / (mu * (gamma_val + t))
    return lr_fn


def convergence_bound(t: int | np.ndarray, *, l_smooth: float, mu: float,
                      b_const: float, gamma_val: float,
                      dist0_sq: float) -> np.ndarray:
    """RHS of Theorem 1: L/(γ+t) (2B/μ² + (γ+1)/2 ‖z¹−z*‖²)."""
    t = np.asarray(t, dtype=np.float64)
    v = 2.0 * b_const / mu ** 2 + (gamma_val + 1.0) / 2.0 * dist0_sq
    return l_smooth / (gamma_val + t) * v


@dataclasses.dataclass(frozen=True)
class TheoremInputs:
    """Problem-instance constants appearing in Theorem 1."""

    l_smooth: float           # L
    mu: float                 # μ
    g2: float                 # G² (bounded gradient energy, Assumption 1.3)
    sigma_bar2: float         # σ̄² = (1/n) Σ σ_i²
    gamma_heterogeneity: float  # Γ = (1/n) Σ (F_i(z*) − F_i(z_i*))
    n: int
    k: int
    h: int
    lambda2_hat: float
    dist0_sq: float           # ‖z¹ − z*‖²


def theorem1_curve(inp: TheoremInputs, t_max: int) -> np.ndarray:
    """The full bound curve for t = 1..t_max."""
    a = alpha(inp.lambda2_hat)
    g = gamma(inp.l_smooth, inp.mu, inp.h)
    b = bound_constant_B(
        k=inp.k, alpha_val=a, h=inp.h, g2=inp.g2, l_smooth=inp.l_smooth,
        gamma_heterogeneity=inp.gamma_heterogeneity,
        sigma_bar2=inp.sigma_bar2, n=inp.n)
    ts = np.arange(1, t_max + 1)
    return convergence_bound(ts, l_smooth=inp.l_smooth, mu=inp.mu,
                             b_const=b, gamma_val=g, dist0_sq=inp.dist0_sq)
