"""The distribution 𝒲 of mixing matrices W^t (repro/core/mixing.py).

With ``p_fail == 0`` W^t is the fixed matrix of the graph's weight scheme
(numpy, identical to the reference), cast to ``dtype``.  With link
failures, each edge is down with probability ``p_fail`` and W^t is the
Metropolis matrix of the surviving subgraph, built from an (n, n) block of
uniforms exactly as the reference builds it from ``jax.random.uniform`` —
so a test that feeds the reference's uniforms gets the reference's W^t.
The spectral constant of Theorem 1, |λ̂₂| = λ₂(E[WWᵀ]), is exact (W²)
without failures and a Monte-Carlo mean over sampled W^t with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws

__all__ = ["MixingDistribution", "identity_mixing",
           "metropolis_from_uniforms", "sample_metropolis_traced",
           "staleness_tilted_weights"]


@dataclasses.dataclass(frozen=True)
class MixingDistribution:
    """𝒲: the base graph, the link-failure rate, the fixed-W scheme and
    the dtype of the sampled W^t."""

    graph: topo.Graph
    p_fail: float = 0.0
    scheme: topo.WeightScheme = "laplacian"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not 0.0 <= self.p_fail < 1.0:
            raise ValueError(f"p_fail must be in [0,1), got {self.p_fail}")

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def fixed_w(self) -> np.ndarray:
        """The deterministic W used when p_fail == 0 (f64, numpy)."""
        return topo.build_weights(self.graph, self.scheme)

    def make_sampler(self, device):
        """sample(draws, t) -> W^t, (n, n) in ``dtype`` on ``device``.

        The fixed W is moved to the device once; with link failures every
        call draws the step's uniforms from ``draws``.
        """
        if self.p_fail == 0.0:
            w = torch.as_tensor(self.fixed_w, dtype=self.dtype,
                                device=device)
            return lambda draws, t: w
        adj = torch.as_tensor(self.graph.adjacency, device=device)
        p_fail = self.p_fail
        return lambda draws, t: metropolis_from_uniforms(
            draws.link_uniforms(t, self.n), adj, p_fail, self.dtype)

    # -- the spectral quantities of Theorem 1 (repro/core/mixing.py:70-96) --

    def sample_batch(self, draws, num: int) -> torch.Tensor:
        """(num, n, n) W draws: sample i from ``draws.link_uniforms(i, n)``
        (the reference's i-th key of ``split(key, num)``), all built in one
        batched call on the uniforms' device (the fixed W on the CPU)."""
        if self.p_fail == 0.0:
            w = torch.as_tensor(self.fixed_w, dtype=self.dtype)
            return w.expand(num, self.n, self.n)
        u = torch.stack([draws.link_uniforms(i, self.n)
                         for i in range(num)])
        adj = torch.as_tensor(self.graph.adjacency, device=u.device)
        return metropolis_from_uniforms(u, adj, self.p_fail, self.dtype)

    def expected_wwt(self, draws=None, num_samples: int = 4096) -> np.ndarray:
        """E_W[W Wᵀ] (f64 numpy): exact (W²) when p_fail == 0, else the
        mean over ``num_samples`` draws in the mixing dtype (``draws``
        defaults to a CPU Draws of seed 0)."""
        if self.p_fail == 0.0:
            w = self.fixed_w
            return w @ w.T
        if draws is None:
            draws = Draws(0, "cpu")
        ws = self.sample_batch(draws, num_samples)
        wwt = torch.einsum("kij,klj->il", ws, ws) / num_samples
        return wwt.cpu().numpy().astype(np.float64)

    def lambda2_hat(self, draws=None, num_samples: int = 4096) -> float:
        """|λ̂₂| = |λ₂(E[WWᵀ])| — the connectivity constant of Theorem 1."""
        return topo.lambda2(self.expected_wwt(draws, num_samples))

    def alpha(self, draws=None, num_samples: int = 4096) -> float:
        """α = |λ̂₂|/(1 − |λ̂₂|) — the factor multiplying H in B (Thm. 1)."""
        return topo.alpha_from_lambda2_hat(
            self.lambda2_hat(draws, num_samples))


def metropolis_from_uniforms(u: torch.Tensor, adjacency: torch.Tensor,
                             p_fail, dtype=None) -> torch.Tensor:
    """Metropolis weights on the subgraph whose links survive ``u``.

    The upper triangle of ``u`` is mirrored so failures are symmetric; a
    link is live when ``u >= p_fail``.  Rows sum to 1 by the diagonal.  The
    weights and their row sums are computed in ``dtype`` (default u's), as
    the reference computes them in the mixing dtype.
    Works over leading batch dimensions: a lattice passes (R, n, n) ``u``
    and adjacency with ``p_fail`` of shape (R, 1, 1), and gets every run's
    W^t in one call.
    """
    u = torch.triu(u, diagonal=1)
    u = u + u.transpose(-1, -2)
    live = adjacency & (u >= p_fail)
    deg = live.sum(dim=-1)
    dmax = torch.maximum(deg[..., :, None], deg[..., None, :])
    dtype = u.dtype if dtype is None else dtype
    w = torch.where(live, 1.0 / (1.0 + dmax.to(dtype)),
                    torch.zeros((), dtype=dtype, device=u.device))
    diag = torch.diagonal(w, dim1=-2, dim2=-1)
    diag.zero_()
    diag.copy_(1.0 - w.sum(dim=-1))
    return w


#: The reference's name for :func:`metropolis_from_uniforms`
#: (repro/core/mixing.py:106): its body on the uniforms that the
#: reference draws from its key, which the port's Draws supplies.
sample_metropolis_traced = metropolis_from_uniforms


def staleness_tilted_weights(w: np.ndarray, ages: np.ndarray,
                             beta: float) -> np.ndarray:
    """FedPAE-style age tilt of a mixing matrix (numpy, host side;
    repro/core/mixing.py:128-157).

    Each off-diagonal column j is scaled by its sender's freshness
    ``s_j = 1/(1 + β·age_j)`` (age_j: rounds since agent j last took
    part) and the diagonal rebuilt so that rows still sum to 1.  β = 0
    returns ``w`` itself.  The result is row-stochastic but in general not
    doubly stochastic (it returns to the symmetric W as all ages → 0).
    """
    if beta == 0.0:
        return w
    if beta < 0.0:
        raise ValueError(f"staleness β must be ≥ 0, got {beta}")
    w = np.asarray(w, dtype=np.float64)
    ages = np.asarray(ages, dtype=np.float64)
    if ages.shape != (w.shape[0],):
        raise ValueError(
            f"ages must be ({w.shape[0]},), got {ages.shape}")
    fresh = 1.0 / (1.0 + beta * np.maximum(ages, 0.0))
    out = w * fresh[None, :]
    np.fill_diagonal(out, 0.0)
    np.fill_diagonal(out, 1.0 - out.sum(axis=1))
    return out


def identity_mixing(n: int) -> MixingDistribution:
    """Degenerate 𝒲 = {I}: no inter-agent communication ⇒ FedAvg."""
    empty = topo.Graph(np.zeros((n, n), dtype=bool), name=f"isolated(n={n})")
    return MixingDistribution(graph=empty, p_fail=0.0, scheme="metropolis")
