"""The paper's §4 linear-regression problem (repro/data/linreg.py).

  F_i(z) = (1/M) ‖X_i z − Y_i‖²,   X_i ∈ ℝ^{M×d},  M = 10,  d = 25,

with [X_i]_j ~ 𝒩(0, 0.25²) and Y_i = c_i (v + cos v), v = X_i·1,
c_i = 2^i: strongly non-iid agents.  :func:`make_problem` is the
reference's numpy code, so the same seed gives the same instance bit for
bit, with every constant Theorem 1 needs (L, μ, Γ, z*, f*).

The engines see one agent's parameters as the single-leaf dict
``{"z": (d,)}`` (a flat spec of one segment, D = d) and one agent's
minibatch as ``{"x": (m, d), "y": (m,)}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["LinRegProblem", "make_problem", "make_grad_fn",
           "sample_minibatch"]


@dataclasses.dataclass(frozen=True)
class LinRegProblem:
    """A fixed problem instance shared by FedDec/FedAvg runs (numpy)."""

    x: np.ndarray          # (n, M, d)
    y: np.ndarray          # (n, M)
    z_star: np.ndarray     # (d,) global minimiser of f = (1/n) Σ F_i
    f_star: float          # f(z*)
    l_smooth: float        # L = max_i 2 λ_max(X_iᵀX_i)/M
    mu: float              # μ = λ_min of the average Hessian
    gamma_heterogeneity: float  # Γ = (1/n) Σ (F_i(z*) − F_i(z_i*))

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def d(self) -> int:
        return self.x.shape[2]

    @property
    def m_rows(self) -> int:
        return self.x.shape[1]

    def local_cost(self, z: np.ndarray, i: int) -> float:
        r = self.x[i] @ z - self.y[i]
        return float(r @ r / self.m_rows)

    def global_cost(self, z: np.ndarray) -> float:
        r = np.einsum("imd,d->im", self.x, z) - self.y
        return float((r ** 2).sum(-1).mean() / self.m_rows)

    def global_cost_stacked(self, z_stacked: torch.Tensor) -> torch.Tensor:
        """f(z̄) with z̄ the mean over the agent dim of an (n, d) tensor,
        in its dtype and on its device."""
        zbar = z_stacked.mean(dim=0)
        x = torch.as_tensor(self.x, dtype=zbar.dtype, device=zbar.device)
        y = torch.as_tensor(self.y, dtype=zbar.dtype, device=zbar.device)
        r = torch.einsum("imd,d->im", x, zbar) - y
        return torch.sum(r ** 2, dim=-1).mean() / self.m_rows

    def suboptimality(self, z_stacked: torch.Tensor) -> torch.Tensor:
        """f(z̄^t) − f(z*): the quantity Theorem 1 bounds."""
        return self.global_cost_stacked(z_stacked) - self.f_star


def make_problem(n: int = 20, m_rows: int = 10, d: int = 25,
                 seed: int = 0, c_base: float = 2.0) -> LinRegProblem:
    """Generate the paper's instance (n=20, M=10, d=25, c_i = 2^i)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.25, size=(n, m_rows, d))
    v = x.sum(axis=2)                        # v = X_i 1  (M,)
    c = c_base ** np.arange(1, n + 1)        # c_i = 2^i, i ∈ [n]
    y = c[:, None] * (v + np.cos(v))

    # Global minimiser of f(z) = (1/n) Σ_i (1/M)‖X_i z − Y_i‖²  (closed form).
    a = np.einsum("imd,ime->de", x, x)       # Σ_i X_iᵀ X_i
    b = np.einsum("imd,im->d", x, y)         # Σ_i X_iᵀ Y_i
    z_star = np.linalg.solve(a, b)

    # Smoothness / strong convexity: ∇²F_i = 2 X_iᵀX_i / M.
    hess = 2.0 * np.einsum("imd,ime->ide", x, x) / m_rows
    eigs = np.linalg.eigvalsh(hess)          # (n, d)
    l_smooth = float(eigs[:, -1].max())
    mu = float(np.linalg.eigvalsh(hess.mean(axis=0))[0])

    # Γ = (1/n) Σ (F_i(z*) − F_i(z_i*)), z_i* the local least-squares solution.
    gamma_h = 0.0
    for i in range(n):
        zi = np.linalg.lstsq(x[i], y[i], rcond=None)[0]
        ri_star = x[i] @ zi - y[i]
        ri_glob = x[i] @ z_star - y[i]
        gamma_h += (ri_glob @ ri_glob - ri_star @ ri_star) / m_rows
    gamma_h /= n

    r = np.einsum("imd,d->im", x, z_star) - y
    f_star = float((r ** 2).sum(-1).mean() / m_rows)

    return LinRegProblem(x=x, y=y, z_star=z_star, f_star=f_star,
                         l_smooth=l_smooth, mu=max(mu, 1e-12),
                         gamma_heterogeneity=float(gamma_h))


def sample_minibatch(problem: LinRegProblem, idx: torch.Tensor,
                     dtype=torch.float64) -> dict:
    """Per-agent minibatch ξ_i^t from injected row indices.

    ``idx`` is (n, m) int64 (rows of each agent's data, drawn uniformly
    with replacement by the caller); returns ``{"x": (n, m, d), "y":
    (n, m)}`` in ``dtype`` on idx's device, the leading dim the agents.
    """
    x = torch.as_tensor(problem.x, dtype=dtype, device=idx.device)
    y = torch.as_tensor(problem.y, dtype=dtype, device=idx.device)
    return {"x": torch.take_along_dim(x, idx[..., None], dim=1),
            "y": torch.take_along_dim(y, idx, dim=1)}


def make_grad_fn(m_rows: int):
    """One agent's line 4 (an engine.GradFn) on a minibatch of m rows.

    The stochastic gradient of F_i at z on rows ξ is (2/m) Xξᵀ(Xξ z − Yξ),
    written out (no autograd), so it holds under the engines'
    ``torch.func.vmap`` over every agent row.
    """
    del m_rows  # the minibatch is pre-sampled; kept for API symmetry

    def grad_fn(params: dict, batch: dict):
        xb, yb = batch["x"], batch["y"]      # (m, d), (m,)
        r = xb @ params["z"] - yb
        loss = torch.mean(r ** 2)
        return loss, {"z": 2.0 * xb.T @ r / xb.shape[0]}

    return grad_fn
