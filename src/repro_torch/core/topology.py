"""Communication graphs, their mixing weights and the spectral constants
of Theorem 1 (numpy, host side).

The port's own copy of the parts of repro/core/topology.py that the flat
trainer, the sweep lattice and the paper's experiments use.  Everything
here is numpy, so it matches the reference exactly: the same graphs, the
same f64 weight matrices and the same |λ₂|.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["Graph", "ring_graph", "fully_connected_graph", "chain_graph",
           "is_connected", "geographic_graph", "erdos_renyi_graph",
           "laplacian_weights", "metropolis_weights", "max_degree_weights",
           "build_weights", "csr_edges", "N_DENSE_MAX", "check_dense_size",
           "lambda2", "lambda2_batched", "lambda2_hat_fixed",
           "lambda2_hat_fixed_batched", "alpha_from_lambda2_hat"]

WeightScheme = Literal["laplacian", "metropolis", "max_degree"]

#: Largest n for which the dense (n, n) helpers will allocate; above it
#: they raise instead of densifying (override per call with
#: ``n_dense_max=``).
N_DENSE_MAX = 4096


def check_dense_size(n: int, what: str, n_dense_max: int | None = None) -> int:
    """Guard against a latent O(n²) densification: raises ``ValueError``
    when ``n`` exceeds ``n_dense_max`` (default :data:`N_DENSE_MAX`)."""
    limit = N_DENSE_MAX if n_dense_max is None else int(n_dense_max)
    if n > limit:
        raise ValueError(
            f"{what} would materialize a dense ({n}, {n}) array "
            f"(n_dense_max={limit}); pass a larger n_dense_max explicitly "
            f"(the sparse CSR graphs are not ported)")
    return n


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected communication graph.

    Attributes:
      adjacency: (n, n) bool, symmetric, zero diagonal.
      name: human-readable tag used in logs.
    """

    adjacency: np.ndarray
    name: str = "graph"

    def __post_init__(self):
        a = np.asarray(self.adjacency, dtype=bool)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric")
        if np.any(np.diag(a)):
            raise ValueError("adjacency must have a zero diagonal")
        object.__setattr__(self, "adjacency", a)

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)


def ring_graph(n: int, k: int = 1) -> Graph:
    """Ring lattice: node i linked to i±1 … i±k (mod n)."""
    adj = np.zeros((n, n), dtype=bool)
    for j in range(1, k + 1):
        idx = np.arange(n)
        adj[idx, (idx + j) % n] = True
        adj[(idx + j) % n, idx] = True
    np.fill_diagonal(adj, False)
    return Graph(adj, name=f"ring(n={n},k={k})")


def fully_connected_graph(n: int) -> Graph:
    return Graph(~np.eye(n, dtype=bool), name=f"full(n={n})")


def chain_graph(n: int) -> Graph:
    """Path graph: node i linked to i±1 (no wrap)."""
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n - 1)
    adj[idx, idx + 1] = True
    adj[idx + 1, idx] = True
    return Graph(adj, name=f"chain(n={n})")


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(adj[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def is_connected(graph: Graph) -> bool:
    return _connected(graph.adjacency)


def geographic_graph(n: int, radius: float, seed: int = 0,
                     max_tries: int = 1000) -> Graph:
    """Connected random geometric graph on the unit square (paper §4)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        pos = rng.uniform(size=(n, 2))
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        adj = (d2 <= radius ** 2) & ~np.eye(n, dtype=bool)
        if _connected(adj):
            return Graph(adj, name=f"geo(n={n},r={radius})")
    raise RuntimeError(
        f"could not draw a connected geographic graph (n={n}, r={radius}) "
        f"in {max_tries} tries; increase the radius")


def erdos_renyi_graph(n: int, p: float, seed: int = 0,
                      max_tries: int = 1000) -> Graph:
    """Connected Erdős–Rényi G(n, p) graph (paper Table 1)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        upper = rng.uniform(size=(n, n)) < p
        adj = np.triu(upper, k=1)
        adj = adj | adj.T
        if _connected(adj):
            return Graph(adj, name=f"er(n={n},p={p})")
    raise RuntimeError(
        f"could not draw a connected ER graph (n={n}, p={p}) "
        f"in {max_tries} tries; increase p")


def laplacian_weights(graph: Graph) -> np.ndarray:
    """Best-constant Laplacian weights W = I − εL, ε = 2/(λ₁(L)+λ_{n−1}(L))."""
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1)
    lap = np.diag(deg) - adj
    eig = np.linalg.eigvalsh(lap)
    eps = 2.0 / (eig[-1] + eig[1])
    return np.eye(graph.n) - eps * lap


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Metropolis–Hastings weights W_ij = 1/(1+max(d_i,d_j)) on edges."""
    adj = graph.adjacency
    deg = adj.sum(axis=1)
    dmax = np.maximum(deg[:, None], deg[None, :])
    w = np.where(adj, 1.0 / (1.0 + dmax), 0.0)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def max_degree_weights(graph: Graph) -> np.ndarray:
    """Uniform 1/(d_max+1) edge weights."""
    adj = graph.adjacency
    dmax = int(adj.sum(axis=1).max())
    w = np.where(adj, 1.0 / (dmax + 1.0), 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


_SCHEMES = {
    "laplacian": laplacian_weights,
    "metropolis": metropolis_weights,
    "max_degree": max_degree_weights,
}


def build_weights(graph: Graph,
                  scheme: WeightScheme = "laplacian") -> np.ndarray:
    try:
        fn = _SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown weight scheme {scheme!r}; "
                         f"choose from {sorted(_SCHEMES)}") from None
    return fn(graph)


def csr_edges(graph: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Receiver-sorted directed edge list ``(receivers, senders, indptr)``
    without self-loops (the diagonal term is applied separately)."""
    recv, send = np.nonzero(graph.adjacency)
    recv = recv.astype(np.int32)
    send = send.astype(np.int32)
    counts = np.bincount(recv, minlength=graph.n)
    indptr = np.zeros(graph.n + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return recv, send, indptr


# ---------------------------------------------------------------------------
# Spectral quantities of Theorem 1
# ---------------------------------------------------------------------------


def lambda2(w: np.ndarray, n_dense_max: int | None = None) -> float:
    """|λ₂(W)|: the second-largest eigenvalue magnitude of a symmetric W
    (a dense O(n³) eigendecomposition; above ``n_dense_max`` it raises)."""
    w = np.asarray(w)
    check_dense_size(w.shape[-1], "lambda2", n_dense_max)
    eig = np.linalg.eigvalsh(np.asarray(w, dtype=np.float64))
    mags = np.sort(np.abs(eig))[::-1]
    return float(mags[1])


def lambda2_batched(ws: np.ndarray) -> np.ndarray:
    """|λ₂| for a stacked (R, n, n) batch of symmetric Ws in one call;
    LAPACK factorises each slice as :func:`lambda2` does, so every entry
    equals the per-matrix value bit for bit."""
    eig = np.linalg.eigvalsh(np.asarray(ws, dtype=np.float64))
    mags = np.sort(np.abs(eig), axis=-1)[:, ::-1]
    return mags[:, 1]


def lambda2_hat_fixed_batched(ws: np.ndarray) -> np.ndarray:
    """Batched :func:`lambda2_hat_fixed`: |λ̂₂| = |λ₂|² per stacked W."""
    return lambda2_batched(ws) ** 2


def lambda2_hat_fixed(w: np.ndarray) -> float:
    """|λ̂₂| = |λ₂(E[WWᵀ])| for a fixed W: E[WWᵀ] = W², so |λ̂₂| = |λ₂|²
    (paper §3)."""
    return float(lambda2(w) ** 2)


def alpha_from_lambda2_hat(lam2_hat: float) -> float:
    """α = |λ̂₂| / (1 − |λ̂₂|) — Theorem 1 / Lemma 3."""
    if not 0.0 <= lam2_hat < 1.0:
        raise ValueError(f"|λ̂₂| must be in [0, 1), got {lam2_hat}")
    return lam2_hat / (1.0 - lam2_hat)
