"""The gossip averaging step x_i ← Σ_j W_ij x_j (Algorithm 1, line 6).

Plain torch counterparts of repro/core/gossip.py for the flat (n, D)
buffer, the (R, n, D) buffer of a sweep lattice and the tree engine's
stacked dict of (n, ...) leaves, mixed leaf by leaf.  The ELL neighbour
mix goes through kernels/ops.py, which runs the plain version for CPU
tensors and the CUDA kernel for CUDA ones; like the reference's Pallas
kernels, it mixes in f32 whatever the buffer's dtype.  The plain mixes
here (the dense product, the CSR gather, the stacked-ELL mix of a lattice
too skewed for the kernel) round W to the buffer's dtype and mix in it, as
the reference's plain mixes do: a float64 buffer is mixed in float64, and
a bf16 one with W in bf16 (the dense product summed in f32, as XLA sums
a bf16 product).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.kernels import ref
from repro_torch.tree import tree_map

__all__ = ["ELL_MAX_DEG", "mix_dtype", "gossip_mix_dense",
           "make_sparse_gossip", "make_sparse_gossip_tree",
           "lattice_max_degree", "stacked_ell_tables",
           "make_sparse_gossip_batched", "make_permute_gossip",
           "gossip_mix_permute"]

ELL_MAX_DEG = 16  # below this, the padded neighbour loop beats CSR scatter

def mix_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the dense product computes in: x's, and at least f32."""
    return torch.promote_types(x.dtype, torch.float32)


def _dense_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    dt = mix_dtype(x)
    if w.ndim == 2 and x.ndim != 2:  # one (n, ...) leaf of a stacked tree
        return _dense_rows(w, x.reshape(x.shape[0], -1)).view(x.shape)
    # W rounded to the buffer's dtype first, as the reference casts it
    return torch.matmul(w.to(x.dtype).to(dt), x.to(dt)).to(x.dtype)


def gossip_mix_dense(w: torch.Tensor, x):
    """y = W x as one (n, n) @ (n, D) matrix product (one batched product
    over a lattice's (R, n, n) W), the reference's einsum with W cast to
    the buffer's dtype (repro/core/engine.py:155-158): W is rounded to
    x's dtype, then the product is taken in mix_dtype(x) and rounded back
    to x's dtype, as XLA takes a bf16 product.  A stacked tree (a dict of
    (n, ...) leaves) is mixed leaf by leaf the same way
    (repro/core/gossip.py:52-65)."""
    return tree_map(lambda leaf: _dense_rows(w, leaf), x)


def make_sparse_gossip(graph: topo.Graph):
    """Neighbour-only mix over the graph's static edge structure.

    * isolated graph (FedAvg 𝒲 = {I}): y = W_ii x_i;
    * max degree ≤ ELL_MAX_DEG: the ELL mix (kernel #2 on CUDA), in f32
      as the reference's kernel #2 mixes;
    * skewed degrees: gather over the receiver-sorted CSR edge list and
      ``index_add_`` into the receivers, O(|E|·D), in the buffer's dtype.
    """
    max_deg = int(graph.degrees.max()) if graph.n else 0
    if max_deg == 0:
        return lambda w, x: torch.diagonal(w.to(x.dtype))[:, None] * x
    if max_deg <= ELL_MAX_DEG:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.make_sparse_gossip(graph)

    recv, send, _ = topo.csr_edges(graph)
    cache = {}

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if x.device not in cache:
            cache[x.device] = (torch.as_tensor(recv, device=x.device).long(),
                               torch.as_tensor(send, device=x.device).long())
        r, s = cache[x.device]
        wd = w.to(x.dtype)
        own = torch.diagonal(wd)[:, None] * x
        return own.index_add(0, r, wd[r, s][:, None] * x[s])

    return mix


def make_sparse_gossip_tree(graph: topo.Graph):
    """Leaf-wise application of :func:`make_sparse_gossip` to a stacked
    tree (the tree engine's ``gossip_impl='sparse'``,
    repro/core/gossip.py:217-225): each leaf is viewed as its contiguous
    (n, D_leaf) rows, so an ELL-range graph launches kernel #2 once per
    leaf on the card."""
    rows_mix = make_sparse_gossip(graph)

    def mix(w: torch.Tensor, stacked):
        def leaf_mix(leaf):
            rows = leaf.contiguous().view(leaf.shape[0], -1)
            return rows_mix(w, rows).view(leaf.shape)
        return tree_map(leaf_mix, stacked)

    return mix


def lattice_max_degree(graphs) -> int:
    """The max degree over an R-run graph lattice: the shared ELL width."""
    return max((int(g.degrees.max()) if g.n else 0) for g in graphs)


def stacked_ell_tables(graphs):
    """Per-run ELL neighbour tables of a lattice, stacked.

    Every run's neighbour lists are padded to the lattice's max degree;
    padded slots point at the row's own index, so a weight of 0 makes them
    exact +0.0 contributions.

    Returns:
      (nbr, valid, max_deg): nbr (R, n, max(max_deg, 1)) int32 and valid
      (same shape) bool marking real edges.
    """
    n = graphs[0].n
    max_deg = max(lattice_max_degree(graphs), 1)
    nbr = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                  (len(graphs), 1, max_deg))
    valid = np.zeros((len(graphs), n, max_deg), dtype=bool)
    for r, g in enumerate(graphs):
        for i in range(n):
            js = np.flatnonzero(g.adjacency[i])
            nbr[r, i, :len(js)] = js
            valid[r, i, :len(js)] = True
    return nbr, valid, max_deg


def make_sparse_gossip_batched(graphs):
    """Neighbour-only mix over an R-run topology lattice (sweep engine).

    Each run's neighbour list is padded to the lattice's max degree with
    weight-0 self slots, so every run's slice equals its own single-run
    ELL mix.  When 0 < max_deg ≤ ELL_MAX_DEG the mix is kernel #6 on CUDA
    (one launch for all runs); otherwise (an all-edgeless lattice, or one
    too skewed for the kernel) it is the plain stacked-ELL mix, W read in
    the buffer's dtype and every product and sum rounded to it, as the
    reference's (repro/core/gossip.py:199-211).  A run
    whose graph has no edges, given W = I, reduces exactly to ``y = x``.

    Returns:
      mix(w, x) -> y for w (R, n, n), x (R, n, D).
    """
    from repro_torch.kernels import ops as kernel_ops
    if 0 < lattice_max_degree(graphs) <= ELL_MAX_DEG:
        return kernel_ops.make_sparse_gossip_batched(graphs)
    nbr, valid, _ = stacked_ell_tables(graphs)
    tables = kernel_ops.EllTables(nbr, valid)

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return ref.ell_mix(*tables.weights(w, x, x.dtype), x, x.dtype)

    return mix


def make_permute_gossip(graph: topo.Graph, mesh, agent_axes="agents",
                        leaf_specs=None, exchange_dtype=None):
    """Neighbour-only gossip over a static topology with one agent a rank
    (repro/core/gossip.py:228-327), for the tree engine's ``gossip_fn``.

    The graph's directed edges split into permutation rounds
    (``topology.permutation_schedule``); each round is one point-to-point
    exchange of this rank's leaves with its round partners, all rounds
    posted at once (``batch_isend_irecv``), so a rank moves its deg
    neighbours' rows rather than every agent's.  The mixing weights may
    still change every step (link failures): the sampled W is passed in
    and each rank reads its own row.  The self term and the received
    rows are accumulated in f32; ``exchange_dtype`` casts what goes on the
    wire (e.g. bf16) and back.  Needs graph.n == the mesh's agent-axis
    size: one agent per rank.

    ``leaf_specs`` (the reference's tensor-parallel inner placements)
    needs tensor-parallel model compute, which the port does not have
    (ROADMAP Queue A item 6).

    Returns ``gossip(w, stacked) -> stacked`` on this rank's (1, ...)
    leaves, every rank calling it together.
    """
    from repro_torch.core import sharded as sharded_lib
    if leaf_specs is not None:
        raise NotImplementedError(
            "leaf_specs (tensor-parallel inner partition specs) is not "
            "ported to repro_torch yet; see ROADMAP.md Queue A item 6")
    axes = (agent_axes,) if isinstance(agent_axes, str) \
        else tuple(agent_axes)
    n_mesh = sharded_lib.agent_axis_size(mesh, axes)
    if graph.n != n_mesh:
        raise ValueError(
            f"permute gossip needs one agent per mesh slice: graph has "
            f"{graph.n} agents but agent axes {axes} have {n_mesh}")
    shard = sharded_lib._shard_of(mesh, axes, graph.n)
    schedule = topo.permutation_schedule(graph)
    halo = sharded_lib._Halo(shard, np.stack(schedule) if schedule
                             else np.zeros((0, graph.n), np.int64))
    me = shard.me

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        row = w[me].float()
        xs = x if exchange_dtype is None else x.to(exchange_dtype)
        received, works = halo.post(xs)
        acc = x.float() * row[me]
        sharded_lib._wait(works)
        # an idle round (perm[me] == me) received nothing and must not
        # count this agent twice
        for src, recv in zip(halo.srcs, received):
            if recv is not None:
                acc = acc + row[src] * recv.float()
        return acc.to(x.dtype)

    def gossip(w: torch.Tensor, stacked):
        return tree_map(lambda leaf: mix(w, leaf), stacked)

    return gossip


def gossip_mix_permute(w: torch.Tensor, stacked, *, graph: topo.Graph, mesh,
                       agent_axes="agents"):
    """One-shot convenience wrapper over :func:`make_permute_gossip`."""
    return make_permute_gossip(graph, mesh, agent_axes)(w, stacked)
