"""Communication graphs and their mixing weights (numpy, host side).

The port's own copy of the parts of repro/core/topology.py that the flat
trainer uses.  Everything here is numpy, so it matches the reference
exactly: the same graphs and the same f64 weight matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["Graph", "ring_graph", "fully_connected_graph",
           "geographic_graph", "erdos_renyi_graph", "laplacian_weights",
           "metropolis_weights", "max_degree_weights", "build_weights",
           "csr_edges"]

WeightScheme = Literal["laplacian", "metropolis", "max_degree"]


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
