"""Communication graphs, their mixing weights and the spectral constants
of Theorem 1 (numpy, host side).

The port's own copy of the parts of repro/core/topology.py that the flat
trainer, the sweep lattice, the paper's experiments and the population
engine use: the dense (n, n) graphs, and the CSR :class:`SparseGraph` of
the n_total ≫ N_DENSE_MAX population regime with its induced cohort
subgraphs, Metropolis weights and |λ₂|, none of which builds an (n, n)
array.  Everything here is numpy, so it matches the reference exactly:
the same graphs, the same f64 weight matrices and the same |λ₂|.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

__all__ = ["Graph", "SparseGraph", "ring_graph", "ring_graph_csr",
           "fully_connected_graph", "chain_graph", "csr_from_graph",
           "induced_subgraph", "is_connected", "geographic_graph",
           "erdos_renyi_graph", "laplacian_weights", "metropolis_weights",
           "metropolis_weights_csr", "max_degree_weights", "build_weights",
           "edge_list", "csr_edges", "permutation_schedule", "N_DENSE_MAX", "check_dense_size",
           "lambda2", "lambda2_batched", "lambda2_sparse",
           "lambda2_hat_fixed", "lambda2_hat_fixed_batched",
           "alpha_from_lambda2_hat"]

WeightScheme = Literal["laplacian", "metropolis", "max_degree"]

#: Largest n for which the dense (n, n) helpers will allocate; above it
#: they raise instead of densifying: the population engine's n_total =
#: 1e6 stays in CSR form (override per call with ``n_dense_max=``).
N_DENSE_MAX = 4096


def check_dense_size(n: int, what: str, n_dense_max: int | None = None) -> int:
    """Guard against a latent O(n²) densification: raises ``ValueError``
    when ``n`` exceeds ``n_dense_max`` (default :data:`N_DENSE_MAX`),
    with the reference's message (repro/core/topology.py:67-80)."""
    limit = N_DENSE_MAX if n_dense_max is None else int(n_dense_max)
    if n > limit:
        raise ValueError(
            f"{what} would materialize a dense ({n}, {n}) array "
            f"(n_dense_max={limit}); use SparseGraph and the CSR variants "
            f"(csr_from_graph / metropolis_weights_csr / lambda2_sparse / "
            f"induced_subgraph) or pass a larger n_dense_max explicitly")
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
    def num_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

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


# ---------------------------------------------------------------------------
# Sparse (CSR) graphs: the n ≫ N_DENSE_MAX population regime
# (repro/core/topology.py:210-357)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """An undirected graph in CSR form, with no (n, n) array.

    The population engine (core/population.py) keeps its n_total-node
    topology in this form and densifies only the induced cohort subgraphs
    (cohort_size ≤ :data:`N_DENSE_MAX`) through :func:`induced_subgraph`.

    Attributes:
      indptr: (n+1,) int64; node i's neighbours are
        ``indices[indptr[i]:indptr[i+1]]``.
      indices: (nnz,) int64 neighbour ids, ascending in each row, no
        self-loops, symmetric (j in row i ⇔ i in row j).
      name: a tag for logs.
    """

    indptr: np.ndarray
    indices: np.ndarray
    name: str = "sparse_graph"

    def __post_init__(self):
        indptr = np.ascontiguousarray(self.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(self.indices, dtype=np.int64)
        if indptr.ndim != 1 or indptr.shape[0] < 1:
            raise ValueError(f"indptr must be (n+1,), got {indptr.shape}")
        if np.any(np.diff(indptr) < 0) or indptr[0] != 0:
            raise ValueError("indptr must start at 0 and be non-decreasing")
        if indices.ndim != 1 or indices.shape[0] != indptr[-1]:
            raise ValueError(
                f"indices length {indices.shape} != indptr[-1] {indptr[-1]}")
        n = indptr.shape[0] - 1
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise ValueError("neighbour ids out of range")
        object.__setattr__(self, "indptr", indptr)
        object.__setattr__(self, "indices", indices)

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0]) // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.n else 0

    def validate(self) -> "SparseGraph":
        """The full O(|E| log |E|) structural check (rows strictly
        ascending, no self-loops, symmetric); not run on construction."""
        row = np.repeat(np.arange(self.n, dtype=np.int64),
                        np.diff(self.indptr))
        if np.any(row == self.indices):
            raise ValueError("self-loops are not allowed")
        for i in range(self.n):
            js = self.indices[self.indptr[i]:self.indptr[i + 1]]
            if np.any(np.diff(js) <= 0):
                raise ValueError(f"row {i} neighbours not strictly ascending")
        fwd = set(zip(row.tolist(), self.indices.tolist()))
        if any((j, i) not in fwd for (i, j) in fwd):
            raise ValueError("adjacency must be symmetric")
        return self


def ring_graph_csr(n: int, k: int = 1) -> SparseGraph:
    """CSR ring lattice (node i ↔ i±1 … i±k mod n) for any n, with no
    dense array; ``csr_from_graph(ring_graph(n, k))`` is the same graph."""
    # offsets beyond n//2 alias into duplicate edges
    if n < 3 or k < 1 or 2 * k >= n:
        raise ValueError(f"ring_csr(n={n}, k={k}) needs n ≥ 3 and 2k < n")
    offsets = np.concatenate([np.arange(-k, 0), np.arange(1, k + 1)])
    ids = np.arange(n, dtype=np.int64)
    nbrs = np.sort((ids[:, None] + offsets[None, :]) % n, axis=1)
    indptr = np.arange(n + 1, dtype=np.int64) * (2 * k)
    return SparseGraph(indptr=indptr, indices=nbrs.reshape(-1),
                       name=f"ring_csr(n={n},k={k})")


def csr_from_graph(graph: Graph) -> SparseGraph:
    """Dense Graph → SparseGraph (a row-major nonzero scan: sorted rows)."""
    recv, send = np.nonzero(graph.adjacency)
    counts = np.bincount(recv, minlength=graph.n)
    indptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return SparseGraph(indptr=indptr, indices=send.astype(np.int64),
                       name=f"csr({graph.name})")


def induced_subgraph(graph: "SparseGraph | Graph", ids) -> Graph:
    """The subgraph induced on ``ids``, by a CSR reindex (no dense parent).

    Row r of the result is parent node ``ids[r]`` (the order is kept); an
    edge (r, s) exists iff (ids[r], ids[s]) is a parent edge.  Cost
    O(Σ_{i∈ids} deg(i) · log |ids|), independent of the parent's n.  The
    result is a small dense Graph, ready for :func:`metropolis_weights`
    and the ELL tables.
    """
    ids = np.asarray(ids, dtype=np.int64)
    if ids.ndim != 1:
        raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
    c = ids.shape[0]
    check_dense_size(c, "induced_subgraph")
    if np.unique(ids).shape[0] != c:
        raise ValueError("ids must be unique")
    if isinstance(graph, Graph):
        graph = csr_from_graph(graph)
    if ids.size and (ids.min() < 0 or ids.max() >= graph.n):
        raise ValueError("ids out of range for the parent graph")
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    # the cohort's neighbour slices, each neighbour binary-searched in the
    # cohort's ids
    deg = np.diff(graph.indptr)[ids]
    src = np.repeat(np.arange(c, dtype=np.int64), deg)
    starts = graph.indptr[ids]
    flat = np.concatenate(
        [graph.indices[s:s + d] for s, d in zip(starts, deg)]) \
        if c else np.zeros((0,), dtype=np.int64)
    adj = np.zeros((c, c), dtype=bool)
    if flat.size:
        loc = np.clip(np.searchsorted(sorted_ids, flat), 0, c - 1)
        hit = sorted_ids[loc] == flat
        adj[src[hit], order[loc[hit]]] = True
    return Graph(adj, name=f"induced({graph.name},c={c})")


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


def laplacian_weights(graph: Graph,
                      n_dense_max: int | None = None) -> np.ndarray:
    """Best-constant Laplacian weights W = I − εL, ε = 2/(λ₁(L)+λ_{n−1}(L))."""
    check_dense_size(graph.n, "laplacian_weights", n_dense_max)
    adj = graph.adjacency.astype(np.float64)
    deg = adj.sum(axis=1)
    lap = np.diag(deg) - adj
    eig = np.linalg.eigvalsh(lap)
    eps = 2.0 / (eig[-1] + eig[1])
    return np.eye(graph.n) - eps * lap


def metropolis_weights(graph: Graph,
                       n_dense_max: int | None = None) -> np.ndarray:
    """Metropolis–Hastings weights W_ij = 1/(1+max(d_i,d_j)) on edges."""
    check_dense_size(graph.n, "metropolis_weights", n_dense_max)
    adj = graph.adjacency
    deg = adj.sum(axis=1)
    dmax = np.maximum(deg[:, None], deg[None, :])
    w = np.where(adj, 1.0 / (1.0 + dmax), 0.0)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def max_degree_weights(graph: Graph,
                       n_dense_max: int | None = None) -> np.ndarray:
    """Uniform 1/(d_max+1) edge weights."""
    check_dense_size(graph.n, "max_degree_weights", n_dense_max)
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


def build_weights(graph: Graph, scheme: WeightScheme = "laplacian",
                  n_dense_max: int | None = None) -> np.ndarray:
    try:
        fn = _SCHEMES[scheme]
    except KeyError:
        raise ValueError(f"unknown weight scheme {scheme!r}; "
                         f"choose from {sorted(_SCHEMES)}") from None
    return fn(graph, n_dense_max=n_dense_max)


def metropolis_weights_csr(graph: SparseGraph
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Metropolis weights on a CSR graph, without densifying.

    Returns ``(vals, diag)``: ``vals`` aligned with ``graph.indices``
    (``vals[e] = 1/(1+max(d_i, d_j))`` for directed edge e) and the
    diagonal ``diag[i] = 1 − Σ_j vals``; the values of
    :func:`metropolis_weights` on the dense graph, in O(|E|) memory.
    """
    deg = np.diff(graph.indptr).astype(np.float64)
    row = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr))
    vals = 1.0 / (1.0 + np.maximum(deg[row], deg[graph.indices]))
    diag = 1.0 - np.bincount(row, weights=vals, minlength=graph.n)
    return vals, diag


def edge_list(graph: Graph) -> list[tuple[int, int]]:
    """The undirected edges (i, j), i < j, in row-major order."""
    i, j = np.nonzero(np.triu(graph.adjacency, k=1))
    return list(zip(i.tolist(), j.tolist()))


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


def permutation_schedule(graph: Graph) -> list[np.ndarray]:
    """Decompose the directed edge set into permutation rounds
    (repro/core/topology.py:570-596, the same greedy order).

    Each round is a partial permutation vector ``perm`` with ``perm[i] = j``
    meaning "i receives from j this round" and ``perm[i] = i`` when idle.
    One round is one point-to-point exchange per participant (the sharded
    engine's halo, core/sharded.py; gossip.make_permute_gossip); the number
    of rounds is a greedy edge-colouring bound.
    """
    n = graph.n
    # directed edges (receiver, sender)
    remaining = {(i, j) for i in range(n) for j in range(n)
                 if graph.adjacency[i, j]}
    rounds: list[np.ndarray] = []
    while remaining:
        perm = np.arange(n)
        used_recv: set[int] = set()
        used_send: set[int] = set()
        for (i, j) in sorted(remaining):
            if i not in used_recv and j not in used_send:
                perm[i] = j
                used_recv.add(i)
                used_send.add(j)
        chosen = {(int(i), int(perm[i])) for i in range(n) if perm[i] != i}
        remaining -= chosen
        rounds.append(perm)
    return rounds


def lambda2(w: np.ndarray, n_dense_max: int | None = None) -> float:
    """|λ₂(W)|: the second-largest eigenvalue magnitude of a symmetric W
    (a dense O(n³) eigendecomposition; above ``n_dense_max`` it raises)."""
    w = np.asarray(w)
    check_dense_size(w.shape[-1], "lambda2", n_dense_max)
    eig = np.linalg.eigvalsh(np.asarray(w, dtype=np.float64))
    mags = np.sort(np.abs(eig))[::-1]
    return float(mags[1])


def lambda2_sparse(graph: SparseGraph, vals: np.ndarray | None = None,
                   diag: np.ndarray | None = None, *, iters: int = 2000,
                   tol: float = 1e-12, seed: int = 0) -> float:
    """|λ₂(W)| of a doubly stochastic W on a CSR graph, with no (n, n).

    ``(vals, diag)`` as :func:`metropolis_weights_csr` returns them (its
    values when omitted).  Power iteration on W deflated by its top
    eigenpair (λ₁ = 1, v₁ = 1/√n), one O(|E|) matvec an iteration.
    """
    if vals is None or diag is None:
        vals, diag = metropolis_weights_csr(graph)
    n = graph.n
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.indptr))
    col = graph.indices

    def matvec(x):
        y = diag * x
        np.add.at(y, row, vals * x[col])
        return y

    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x -= x.mean()                       # deflate the all-ones eigenvector
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(iters):
        y = matvec(x)
        y -= y.mean()
        nrm = np.linalg.norm(y)
        if nrm == 0.0:
            return 0.0
        y /= nrm
        lam_new = float(abs(y @ matvec(y)))
        if abs(lam_new - lam) <= tol * max(1.0, abs(lam_new)):
            return lam_new
        lam, x = lam_new, y
    return lam


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
