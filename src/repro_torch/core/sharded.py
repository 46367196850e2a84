"""The agent-sharded flat engine: the (n_agents, D) buffer over a 1-D
mesh of ``torch.distributed`` ranks (repro/core/sharded.py, the 1-D part;
the R-run lattice's composition, repro/core/engine.py:693-1145).

The reference runs one controller over a JAX mesh (``shard_map``).  The
port runs one process per shard in one ``torch.distributed`` group (NCCL
where each rank has its own card, gloo on the CPU) whose 1-D
``DeviceMesh`` has the dim ``"agents"`` (launch/mesh.py).  Rank ``me``
holds the contiguous row block ``[me·n_local, (me+1)·n_local)`` of the
flat state, n_local = n_agents / n_shards ≥ 1, and every Algorithm-1 op
becomes a per-block op plus the minimal collective:

  * the local update (lines 4–5): the flat engine's one vmapped pass over
    the block's n_local rows, no communication;
  * dense gossip: each rank contracts its column block of W against its
    rows (``W[:, cols] @ x_blk``, an (n, D) partial) and one
    ``reduce_scatter_tensor`` both sums the partials and hands each rank
    its row block (the reference's ``psum_scatter``); one shard has no
    collective;
  * sparse / 'pallas' gossip: a halo over the graph's cut edges only.  The
    graph collapses to its block quotient (:func:`quotient_graph`), the
    quotient to permutation rounds (``topology.permutation_schedule``);
    each round moves this rank's boundary rows (:func:`boundary_row_split`)
    to the rank that reads them, every round's ``isend``/``irecv`` posted
    in one ``batch_isend_irecv`` before the own-block contraction, which
    runs while they are in flight (the reference's ``ppermute``).  Under
    'pallas' the own block ``W[rows, rows] @ x_blk`` is kernel #1 (#5 on a
    lattice); the cut-edge slabs are plain products, as in the reference;
  * compressed gossip: the halo moves the encoded payload (int8 + scales,
    top-k values + indices, or bf16) and decodes it on arrival; the dense
    path reduce-scatters the partial over the decoded s and adds
    ``diag(W)·(p − s)``;
  * the server round (lines 8–10): every rank draws the same participants,
    contracts its slice of the c/K weights, and one ``all_reduce`` of the
    (D,) z is the whole server link;
  * the loss: the block's sum, ``all_reduce``-d, over n_agents.

Randomness: W^t, the participants and the codec's noise are the flat
engine's draws.  Every rank holds a draws object of the same seed and
makes the same full draws from it in the same order ((n, n) link
uniforms, (K,) participants, (n, D) int8 noise), then slices its rows,
as the reference derives the full key array and slices it
(repro/core/sharded.py:559-581).  So a test's replay of the reference's
draws serves every rank unchanged, and a sharded run follows the flat
run's trajectory (the sums in another order: within 1e-5·max|x|).  The
int8 noise costs each rank the full (n, D) draw, as on the flat engine.

State: :func:`shard_flat_state` returns this rank's block of a
FlatFedState and :func:`gather_flat_state` assembles the whole one back
(``all_gather_into_tensor``), the counterpart of reading a sharded
``jax.Array``.  The reference's PartitionSpec tables (``flat_state_specs``,
``_leaf_spec``) have no meaning here and are left out.

The 2-D ('agents', 'model') engine (``model_axis`` naming a dim of size
M > 1 of a launch/mesh.make_fed_mesh mesh; repro/core/sharded.py:
726-810): rank (a, m) holds rows ``[a·n/A, (a+1)·n/A)`` × columns
``[m·D/M, (m+1)·D/M)`` of every (n, D) buffer (the flat buffer, the
optimizer's, the residual), stored contiguously, so its state is
``n/A · D/M · b`` bytes.  The reference leaves each agent replica's model
compute to GSPMD over an ``auto`` model axis; the port makes line 4
explicit instead:

  * line 4: the model group all-gathers its (n/A, D/M) blocks into the
    (n/A, D) rows (one ``all_gather_into_tensor`` and a column
    reassembly), runs the 1-D engine's one vmapped fwd+bwd pass over
    them, and keeps its own D/M columns of the gradient.  Every model
    rank of an agent block computes the same losses, so the loss needs
    no model-axis reduction.  Each model rank therefore holds a
    transient (n/A, D) gather and the whole model's compute: what the
    2-D mesh saves is the state.  Tensor-parallel model compute (the
    reference's GSPMD partitioning, its ``leaf_specs``) is not ported;
  * the update (sgd, momentum, nesterov, adamw) is elementwise on the
    block;
  * line 6 runs over the agent dim only, on the column block: the dense
    partial ``W[:, rows] @ x_blk`` is (n, D/M) and reduce-scatters over
    the agents group; the halo sends the boundary rows of the column
    block to the peer with the same model coordinate (global rank
    ``a'·M + m``, through the agents group); the own block goes through
    kernel #1 under 'pallas';
  * the codecs: identity and bf16 are elementwise; int8's per-row scale
    is max|u| over the whole D, so the blocks' row maxima are
    ``all_reduce``-d (MAX) over the model group before quantizing, and
    its noise is the flat run's full (n, D) draw sliced to the block's
    rows and columns; top-k is refused (its indices address the full D);
  * lines 8–10: the (D/M,) slice of z is all-reduced over the agents
    group and written to the block's own columns.

So the only model-axis collectives are the gather of line 4 and int8's
scale maximum; the tree layout, sweep lattices, ``delta`` and
``fuse_update_mix`` raise :func:`engine.model_axis_conflict`, as in the
reference.

The engine never moves a block to the host for a collective: the
collectives take the blocks on their own device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine
from repro_torch.core import flat as flat_lib
from repro_torch.core import gossip as gossip_lib
from repro_torch.core import server as server_lib
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.flat import FlatFedState, FlatSpec, LrFn
from repro_torch.tree import build_tree, sorted_leaves, tree_map

__all__ = ["agent_axis_size", "quotient_graph", "cut_edge_stats",
           "boundary_row_split", "make_sharded_gossip",
           "make_sharded_ef_gossip", "shard_flat_state", "gather_flat_state",
           "make_sharded_feddec_step", "make_sharded_feddec_round",
           "shard_sweep_state", "gather_sweep_state",
           "make_sharded_sweep_step", "make_sharded_sweep_round"]

# torch 2.13 names the tensor forms *_single and deprecates the old names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def agent_axis_size(mesh, axis_name="agents") -> int:
    """Number of shards the agent dim is split into on this mesh."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    sizes = _mesh_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _resolve_axis(mesh, axis_name) -> str:
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    sizes = _mesh_sizes(mesh)
    for a in axes:
        if a not in sizes:
            raise ValueError(f"mesh has no axis {a!r}: {sizes}")
    if len(axes) > 1:
        raise NotImplementedError(
            f"an agent axis over several mesh dims {axes} is not ported to "
            f"repro_torch: its meshes (launch/mesh.py) have one agent dim")
    return axes[0]


def _validate(n_agents: int, mesh, axis_name) -> int:
    n_shards = agent_axis_size(mesh, axis_name)
    if n_agents % n_shards:
        raise ValueError(
            f"n_agents={n_agents} must be divisible by the agent axis "
            f"size {n_shards} (block-sharded rows)")
    return n_shards


def _model_axis_size(mesh, model_axis) -> int:
    """M, the size of the mesh's dim ``model_axis``, which must exist."""
    sizes = _mesh_sizes(mesh)
    if model_axis not in sizes:
        raise ValueError(
            f"mesh has no model axis {model_axis!r}: {sizes} (build one "
            f"with launch.mesh.make_fed_mesh)")
    return sizes[model_axis]


def _validate_model_axis(cfg, d: int, mesh, model_axis) -> int:
    """The reference's model-axis checks (repro/core/sharded.py:537-552):
    the axis must exist and divide D, and top-k gossip compression does
    not compose with a model axis of size > 1.  ``cfg`` may be None (state
    placement has no codec).  Returns M."""
    m = _model_axis_size(mesh, model_axis)
    if d % m:
        raise ValueError(
            f"flat dim D={d} must be divisible by the model axis size {m} "
            f"(column-sharded D/M sub-blocks)")
    if m > 1 and cfg is not None and cfg.gossip_impl != "none" \
            and cfg.gossip_compress.startswith("topk"):
        raise engine.model_axis_conflict(
            "topk gossip compression (the payload indices address the "
            "full D axis)")
    return m


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's place on the agent dim and, on the 2-D mesh, on the
    model dim: agent block ``me`` of ``n_shards`` (its agents group), and
    column block ``m`` of ``n_model`` (its model group; None on a 1-D
    mesh or a model dim of size 1) over the flat dim D."""

    group: object
    me: int
    n_shards: int
    n_local: int
    model_group: object = None
    m: int = 0
    n_model: int = 1
    d: int | None = None

    @property
    def lo(self) -> int:
        return self.me * self.n_local

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.lo + self.n_local)

    @property
    def d_local(self) -> int | None:
        return None if self.d is None else self.d // self.n_model

    @property
    def cols(self) -> slice:
        """This rank's columns of D (all of them on a 1-D mesh)."""
        if self.n_model == 1:
            return slice(None)
        return slice(self.m * self.d_local, (self.m + 1) * self.d_local)

    def peer(self, shard: int) -> int:
        """The global rank of agent shard ``shard`` with this rank's model
        coordinate (the P2P ops take it): ``shard·M + m`` on the 2-D
        mesh."""
        return dist.get_global_rank(self.group, shard)


def _shard_of(mesh, axis_name, n_agents: int, model_axis=None,
              d: int | None = None, cfg=None) -> _Shard:
    """This rank's :class:`_Shard`; with ``model_axis`` (and the flat dim
    ``d``) its column block too, after the reference's model-axis
    checks."""
    ax = _resolve_axis(mesh, axis_name)
    n_shards = _validate(n_agents, mesh, ax)
    shard = _Shard(group=mesh.get_group(ax), me=int(mesh.get_local_rank(ax)),
                   n_shards=n_shards, n_local=n_agents // n_shards, d=d)
    if model_axis is None:
        return shard
    m = _validate_model_axis(cfg, d, mesh, model_axis)
    if m == 1:
        return shard
    return dataclasses.replace(
        shard, model_group=mesh.get_group(model_axis),
        m=int(mesh.get_local_rank(model_axis)), n_model=m)


# ---------------------------------------------------------------------------
# Block-quotient topology: which shards must talk at all
# ---------------------------------------------------------------------------


def quotient_graph(graph: topo.Graph, n_shards: int) -> topo.Graph:
    """Collapse the agent graph to its shard-block quotient
    (repro/core/sharded.py:98-114): shards r ≠ s are adjacent iff any base
    edge crosses between their contiguous blocks; the halo's rounds cover
    only the quotient's edges."""
    n = graph.n
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"n_shards must divide n_agents: {n_shards} ∤ {n}")
    n_local = n // n_shards
    adj = np.asarray(graph.adjacency)
    blocks = adj.reshape(n_shards, n_local, n_shards, n_local).any(axis=(1, 3))
    np.fill_diagonal(blocks, False)
    return topo.Graph(blocks, name=f"quotient({graph.name}/{n_shards})")


def cut_edge_stats(graph: topo.Graph, n_shards: int) -> dict:
    """Static communication metadata of the sharded layout
    (repro/core/sharded.py:117-142): the directed base edges, those whose
    endpoints live on different shards (``num_cut_edges``), the quotient's
    permutation rounds (``num_halo_rounds``) and its max degree."""
    n = graph.n
    n_local = n // n_shards
    recv, send = np.nonzero(np.asarray(graph.adjacency))
    cut = (recv // n_local) != (send // n_local)
    q = quotient_graph(graph, n_shards)
    schedule = topo.permutation_schedule(q)
    return {
        "n_agents": n,
        "n_shards": n_shards,
        "agents_per_shard": n_local,
        "num_directed_edges": int(len(recv)),
        "num_cut_edges": int(cut.sum()),
        "num_halo_rounds": len(schedule),
        "quotient_max_degree": int(q.degrees.max()) if q.n else 0,
    }


def boundary_row_split(graph: topo.Graph, n_shards: int) -> dict:
    """Each shard's rows split into boundary (on an edge, either way, to
    another shard) and interior (repro/core/sharded.py:145-188).  Only
    boundary rows appear in another shard's mix, so the halo moves only
    them.  Host tables padded to the largest boundary count ``b_max``:
    ``index`` (n_shards, b_max) int32 local row ids (0 on padding),
    ``valid`` (n_shards, b_max) bool, ``counts`` (n_shards,), and
    ``n_local``, ``b_max``, ``interior_min``."""
    n = graph.n
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"n_shards must divide n_agents: {n_shards} ∤ {n}")
    n_local = n // n_shards
    adj = np.asarray(graph.adjacency)
    sym = adj | adj.T
    shard_of = np.arange(n) // n_local
    cross = sym & (shard_of[:, None] != shard_of[None, :])
    per = cross.any(axis=1).reshape(n_shards, n_local)
    counts = per.sum(axis=1)
    b_max = int(counts.max()) if n_shards > 0 else 0
    index = np.zeros((n_shards, b_max), np.int32)
    valid = np.zeros((n_shards, b_max), bool)
    for s in range(n_shards):
        rows = np.nonzero(per[s])[0]
        index[s, :len(rows)] = rows
        valid[s, :len(rows)] = True
    return {"index": index, "valid": valid,
            "counts": counts.astype(np.int64),
            "n_local": n_local, "b_max": b_max,
            "interior_min": int(n_local - counts.max()) if n_shards else 0}


def _halo_setup(graph: topo.Graph, n_shards: int):
    """(perms, split): ``perms`` (rounds, n_shards), shard d receiving
    shard perms[r, d]'s payload in round r (itself when idle), and the
    boundary tables that size the payload (repro/core/sharded.py:196-211)."""
    schedule = topo.permutation_schedule(quotient_graph(graph, n_shards))
    perms = np.stack(schedule) if schedule \
        else np.zeros((0, n_shards), np.int64)
    return perms, boundary_row_split(graph, n_shards)


# ---------------------------------------------------------------------------
# The halo exchange
# ---------------------------------------------------------------------------


class _Halo:
    """One rank's side of the permutation rounds: whom it receives from and
    sends to in each round, and one ``batch_isend_irecv`` that posts them
    all.  The first P2P call of an NCCL group wants every rank in it, so
    the group meets at a barrier when the halo is built."""

    def __init__(self, shard: _Shard, perms: np.ndarray):
        self.shard = shard
        me = shard.me
        shards = np.arange(shard.n_shards)
        self.srcs = [int(p[me]) for p in perms]
        self.dsts = [[int(d) for d in np.flatnonzero((p == me)
                                                      & (shards != me))]
                     for p in perms]
        if len(perms) and shard.n_shards > 1:
            dist.barrier(group=shard.group)

    def post(self, payload):
        """Post every round's sends of ``payload`` (a tensor or a dict of
        them) and receives of the peers' payloads at once.  Returns
        (received, works): received[r] is round r's payload tree, None
        when this rank is idle in it; wait on ``works`` before reading."""
        paths, sent = zip(*sorted_leaves(payload)) if isinstance(
            payload, dict) else ((), (payload,))
        sent = [t.contiguous() for t in sent]
        ops, received = [], []
        group = self.shard.group
        for r, (src, dsts) in enumerate(zip(self.srcs, self.dsts)):
            recv = None
            if src != self.shard.me:
                recv = [torch.empty_like(t) for t in sent]
                ops += [dist.P2POp(dist.irecv, t, self.shard.peer(src),
                                   group=group, tag=r * len(sent) + i)
                        for i, t in enumerate(recv)]
                recv = build_tree(paths, recv) if paths else recv[0]
            for d in dsts:
                ops += [dist.P2POp(dist.isend, t, self.shard.peer(d),
                                   group=group, tag=r * len(sent) + i)
                        for i, t in enumerate(sent)]
            received.append(recv)
        works = dist.batch_isend_irecv(ops) if ops else []
        return received, works


def _wait(works) -> None:
    for work in works:
        work.wait()


def _device_tables(split: dict, device) -> tuple:
    """(index, valid) of the boundary tables on ``device``: int64 row
    ids and the bool mask of real (not padded) boundary rows."""
    return (torch.as_tensor(split["index"], dtype=torch.int64,
                            device=device),
            torch.as_tensor(split["valid"], device=device))


def _boundary_wcols(w_rows, index, valid, src: int, n_local: int):
    """Round-r cut-edge weights W[my rows, src's boundary rows], an
    (n_local, b_max) slab with the padding columns zeroed
    (repro/core/sharded.py:214-222; an idle round is skipped by the
    caller, so src is never this rank)."""
    wc = w_rows[:, src * n_local + index[src]]
    return wc * valid[src].to(wc.dtype)[None, :]


def _blk_mix_for(impl: str):
    """The (n_local, n_local) @ (n_local, D) own-block contraction (one
    per run on a lattice): kernel #1 (#5) under 'pallas', the plain
    product (W rounded to the buffer's dtype) otherwise
    (repro/core/sharded.py:225-240, repro/core/engine.py:724-737)."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kernel_ops

        def blk_mix(wb, xb):
            mix = kernel_ops.gossip_mix if xb.ndim == 2 \
                else kernel_ops.gossip_mix_batched
            return mix(wb, xb)
        return blk_mix
    return gossip_lib.gossip_mix_dense


def _reduce_scatter_rows(partial: torch.Tensor, shard: _Shard,
                         like: torch.Tensor) -> torch.Tensor:
    """The (n, D) partials summed over ranks, this rank's (n_local, D)
    rows returned (the reference's tiled ``psum_scatter``)."""
    if shard.n_shards == 1:
        return partial
    out = torch.empty_like(like)
    _reduce_scatter(out, partial.contiguous(), group=shard.group)
    return out


# ---------------------------------------------------------------------------
# Per-shard gossip mixers
# ---------------------------------------------------------------------------


def _make_shard_mixer(cfg: FedDecConfig, shard: _Shard):
    """gossip_impl → mix(w, x_blk) -> y_blk on this rank's block
    (repro/core/sharded.py:243-316): ``w`` is the full (n, n) W^t, the
    same on every rank.  The mix contracts the agent index only, so a 2-D
    mesh's (n_local, D/M) column block mixes as a row block does, over
    the agents group (the reference's ``model_axes`` halo, which exchanges
    (n_local, D/M) sub-blocks between ranks of one model coordinate)."""
    impl = cfg.gossip_impl
    lo, nl, rows = shard.lo, shard.n_local, shard.rows

    if impl == "none":
        return lambda w, x_blk: x_blk

    if impl == "dense":
        def mix(w, x_blk):
            partial = gossip_lib.gossip_mix_dense(w[:, rows], x_blk)
            return _reduce_scatter_rows(partial, shard, x_blk)
        return mix

    if impl in ("sparse", "pallas"):
        perms, split = _halo_setup(cfg.mixing.graph, shard.n_shards)
        halo = _Halo(shard, perms)
        blk_mix = _blk_mix_for(impl)
        tables = {}

        def mix(w, x_blk):
            if x_blk.device not in tables:
                tables[x_blk.device] = _device_tables(split, x_blk.device)
            index, valid = tables[x_blk.device]
            # the boundary rows leave first; the own-block contraction
            # (interior rows and every row's intra-block terms) runs while
            # they are in flight, and only the cut-edge slabs wait
            received, works = halo.post(x_blk.index_select(0, index[shard.me]))
            w_rows = w[rows]
            y = blk_mix(w_rows[:, lo:lo + nl], x_blk)
            _wait(works)
            for src, recv in zip(halo.srcs, received):
                if recv is None:
                    continue
                wc = _boundary_wcols(w_rows, index, valid, src, nl)
                y.add_(gossip_lib.gossip_mix_dense(wc, recv))
            return y
        return mix

    raise engine.unknown_gossip_impl(impl)


def _make_compressed_shard_mixer(cfg: FedDecConfig, shard: _Shard,
                                 compressor):
    """Compressed per-shard mixer (repro/core/sharded.py:319-410):
    mix(w, p_blk, s_blk, payload) -> y_blk with
    y_i = W_ii p_i + Σ_{j≠i} W_ij s_j.  Dense reduce-scatters the partial
    over s; the halo moves the boundary rows of every payload leaf and
    decodes them on arrival (the codec works row by row, so decoding a
    row slice equals slicing the decode)."""
    impl = cfg.gossip_impl
    lo, nl, rows = shard.lo, shard.n_local, shard.rows

    def diag_blk(w, dtype):
        return torch.diagonal(w)[rows].to(dtype)[:, None]

    if impl == "dense":
        def mix(w, p_blk, s_blk, payload):
            partial = gossip_lib.gossip_mix_dense(w[:, rows], s_blk)
            y = _reduce_scatter_rows(partial, shard, s_blk)
            return y.add_(torch.sub(p_blk, s_blk).mul_(
                diag_blk(w, p_blk.dtype)))
        return mix

    if impl in ("sparse", "pallas"):
        perms, split = _halo_setup(cfg.mixing.graph, shard.n_shards)
        halo = _Halo(shard, perms)
        blk_mix = _blk_mix_for(impl)
        tables = {}

        def mix(w, p_blk, s_blk, payload):
            if p_blk.device not in tables:
                tables[p_blk.device] = _device_tables(split, p_blk.device)
            index, valid = tables[p_blk.device]
            mine = index[shard.me]
            received, works = halo.post(tree_map(
                lambda a: a.index_select(0, mine), payload))
            w_rows = w[rows]
            # the diagonal term in place: no second (n_local, D) buffer
            y = blk_mix(w_rows[:, lo:lo + nl], s_blk).add_(torch.sub(
                p_blk, s_blk).mul_(diag_blk(w, p_blk.dtype)))
            _wait(works)
            for src, recv in zip(halo.srcs, received):
                if recv is None:
                    continue
                s_recv = compressor.decode(recv, p_blk.dtype,
                                           p_blk.shape[1])
                wc = _boundary_wcols(w_rows, index, valid, src, nl)
                y.add_(gossip_lib.gossip_mix_dense(wc, s_recv))
            return y
        return mix

    raise engine.unknown_gossip_impl(impl)


def _encode_shard_block(compressor, draws, t, n_agents: int, shard: _Shard,
                        x_blk, res_blk):
    """Per-shard EF encode → (payload, s_blk, new_res): the int8 noise is
    the full (n, D) draw, sliced to this block's rows (and, on the 2-D
    mesh, its columns), so agent i's rounding (and with it s_i and its
    residual) is the flat engine's (repro/core/sharded.py:567-581).  On
    the 2-D mesh int8's per-row scale is the maximum over the whole row:
    the blocks' row maxima are all-reduced over the model group first."""
    u = x_blk + res_blk
    kw = {}
    noise = None
    if compressor.needs_key:
        noise = draws.codec_noise(t, n_agents, u.shape[-1] * shard.n_model
                                  )[..., shard.rows, shard.cols]
        if shard.n_model > 1:
            amax = compressor.row_amax(u)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=shard.model_group)
            kw["row_amax"] = amax
    payload = compressor.encode(noise, u, **kw)
    s_blk = compressor.decode(payload, u.dtype, u.shape[-1])
    return payload, s_blk, u - s_blk


def _check_mesh_device(mesh, device) -> torch.device:
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"the state is on {device}, the mesh's ranks on "
                         f"{mesh.device_type}")
    return device


def make_sharded_gossip(cfg: FedDecConfig, mesh, axis_name="agents"):
    """Whole-buffer gossip on this rank's block (repro/core/sharded.py:
    413-440): ``gossip(w, x_blk) -> y_blk``, every rank calling it
    together.  The mix contracts the agent index only, so it takes a
    column block of a 2-D mesh as it takes a row block."""
    shard = _shard_of(mesh, axis_name, cfg.n_agents)
    return _make_shard_mixer(cfg, shard)


def make_sharded_ef_gossip(cfg: FedDecConfig, mesh, axis_name="agents"):
    """Compressed whole-buffer gossip with error feedback on this rank's
    block (repro/core/sharded.py:443-486): ``gossip(w, p_blk, res_blk,
    draws, t) -> (y_blk, new_res_blk)``, the int8 noise from
    ``draws.codec_noise(t, n, D)`` sliced to the block.  Without a codec
    (or under impl 'none') it is :func:`make_sharded_gossip` with the
    residual passed through."""
    compressor = compress_lib.parse_compress(cfg.gossip_compress)
    if compressor is None or cfg.gossip_impl == "none":
        plain = make_sharded_gossip(cfg, mesh, axis_name)
        return lambda w, p, res, draws, t: (plain(w, p), res)
    shard = _shard_of(mesh, axis_name, cfg.n_agents)
    cmixer = _make_compressed_shard_mixer(cfg, shard, compressor)

    def gossip(w, p_blk, res_blk, draws, t):
        payload, s_blk, new_res = _encode_shard_block(
            compressor, draws, t, cfg.n_agents, shard, p_blk, res_blk)
        return cmixer(w, p_blk, s_blk, payload), new_res

    return gossip


# ---------------------------------------------------------------------------
# State placement
# ---------------------------------------------------------------------------


def _block(t, rows: slice, dim: int, whole: int, cols: slice = slice(None)):
    """Rows ``rows`` of dim ``dim`` (and columns ``cols`` of the last dim)
    of a buffer as a tensor of its own (the buffer itself when the block
    is all of it)."""
    if not isinstance(t, torch.Tensor) or t.ndim != dim + 2:
        return t          # the scalars (adamw's count) are replicated
    if rows.stop - rows.start == whole and cols == slice(None):
        return t
    return t[(slice(None),) * dim + (rows, cols)].clone()


def shard_flat_state(state: FlatFedState, mesh, axis_name="agents",
                     model_axis=None) -> FlatFedState:
    """This rank's block of a FlatFedState (repro/core/sharded.py:
    536-551): the flat buffer, the optimizer's (n, D) buffers and the
    residual block-sharded over the agent rows (and, with ``model_axis``,
    column-sharded over D: rank (a, m)'s ``n/A · D/M`` block, its own
    storage), the scalars replicated."""
    n, d = state.flat.shape
    shard = _shard_of(mesh, axis_name, n, model_axis, d)

    def blk(t):
        return _block(t, shard.rows, 0, n, shard.cols)

    return FlatFedState(flat=blk(state.flat), step=state.step,
                        opt_state=tree_map(blk, state.opt_state),
                        residual=tree_map(blk, state.residual))


def _gather_rows(t, shard: _Shard, dim: int):
    """The whole buffer of every rank's block along ``dim`` (0 or 1)."""
    if not isinstance(t, torch.Tensor) or t.ndim != dim + 2:
        return t
    if shard.n_shards == 1:
        return t
    blk = t.movedim(dim, 0).contiguous()
    out = torch.empty((shard.n_shards * blk.shape[0],) + blk.shape[1:],
                      dtype=blk.dtype, device=blk.device)
    _all_gather(out, blk, group=shard.group)
    return out.movedim(0, dim).contiguous()


def _gather_cols(t, shard: _Shard):
    """The (rows, D) rows of every model rank's (rows, D/M) column block
    of them: one all-gather over the model group, then the columns put
    side by side (the 2-D engine's line-4 gather)."""
    if not isinstance(t, torch.Tensor) or t.ndim != 2 or shard.n_model == 1:
        return t
    rows, dl = t.shape
    out = torch.empty((shard.n_model * rows, dl), dtype=t.dtype,
                      device=t.device)
    _all_gather(out, t.contiguous(), group=shard.model_group)
    return out.view(shard.n_model, rows, dl).transpose(0, 1).reshape(
        rows, shard.n_model * dl)


def gather_flat_state(state_blk: FlatFedState, mesh, axis_name="agents",
                      model_axis=None) -> FlatFedState:
    """The whole FlatFedState from every rank's block
    (``all_gather_into_tensor`` over the model group, then the agents
    group), on every rank."""
    n_local, d_local = state_blk.flat.shape
    n = n_local * agent_axis_size(mesh, axis_name)
    m = 1 if model_axis is None else _mesh_sizes(mesh).get(model_axis, 1)
    shard = _shard_of(mesh, axis_name, n, model_axis, d_local * m)

    def whole(t):
        return _gather_rows(_gather_cols(t, shard), shard, 0)

    return FlatFedState(flat=whole(state_blk.flat), step=state_blk.step,
                        opt_state=tree_map(whole, state_blk.opt_state),
                        residual=tree_map(whole, state_blk.residual))


# ---------------------------------------------------------------------------
# The sharded engine
# ---------------------------------------------------------------------------


def _sum_over_ranks(total: torch.Tensor, shard: _Shard) -> torch.Tensor:
    if shard.n_shards > 1:
        dist.all_reduce(total, group=shard.group)
    return total


def _server_z(weights, x_blk, shard: _Shard) -> torch.Tensor:
    """z = Σ_i weights_i x_i over every rank's rows: this block's
    contraction in column blocks (cuBLAS takes dimensions below 2^31, as
    server.aggregate_and_broadcast_flat), then one ``all_reduce`` of the
    (D,) z."""
    w = weights[shard.rows].to(x_blk.dtype)
    z = torch.empty(x_blk.shape[1], dtype=x_blk.dtype, device=x_blk.device)
    for lo in range(0, x_blk.shape[1], server_lib._SERVER_COLS):
        sl = slice(lo, lo + server_lib._SERVER_COLS)
        z[sl] = torch.matmul(w, x_blk[:, sl].contiguous())
    return _sum_over_ranks(z, shard)


def _shard_ops(cfg: FedDecConfig, spec: FlatSpec, grad_fn: engine.GradFn,
               lr_fn: LrFn, mesh, axis_name, optimizer, device,
               model_axis=None) -> engine.EngineOps:
    """The sharded engine's vtable for the shared Algorithm-1 body
    (repro/core/sharded.py:584-683): the flat engine's ops on this rank's
    block (line 4 one vmapped pass over its n_local rows, the optimizer
    step, η, W^t), with the gossip, the server round and the loss made
    collective.  With ``model_axis`` of size M > 1 the block is a column
    block and line 4 gathers the rows' other columns first (the module
    docstring)."""
    device = _check_mesh_device(mesh, device)
    shard = _shard_of(mesh, axis_name, cfg.n_agents, model_axis, spec.d,
                      cfg)
    n_agents = cfg.n_agents
    agent_grads = None
    if shard.n_model > 1:
        def agent_grads(state, batch):
            # line 4 on the whole rows, this rank's columns kept
            x_rows = _gather_cols(state.flat, shard)
            losses, g = flat_lib.grads_of(spec, grad_fn, x_rows, batch)
            del x_rows
            return losses, g[:, shard.cols].contiguous()
    base = flat_lib._flat_ops(cfg, spec, grad_fn, lr_fn, None, optimizer,
                              device, agent_grads=agent_grads)
    compressor = compress_lib.parse_compress(cfg.gossip_compress) \
        if cfg.gossip_impl != "none" else None
    ef_gossip = None
    if compressor is None:
        gossip = _make_shard_mixer(cfg, shard)
    else:
        cmixer = _make_compressed_shard_mixer(cfg, shard, compressor)
        gossip = base.gossip

        def ef_gossip(w, x_half, res_blk, draws, t):
            # the halo moves the encoded payload
            payload, s_blk, new_res = _encode_shard_block(
                compressor, draws, t, n_agents, shard, x_half, res_blk)
            return cmixer(w, x_half, s_blk, payload), new_res

    def server(draws, t, x_next):
        # lines 8–10: every rank draws the same S_t, contracts its slice
        # of the c/K weights, and the (D,) all-reduce (the (D/M,) slice of
        # it on the 2-D mesh) is the server link
        if not cfg.server_enabled or (t + 1) % cfg.h:
            return x_next
        counts = server_lib.sample_participants(draws, t, n_agents, cfg.k)
        z = _server_z(server_lib.participant_weights(counts, cfg.k),
                      x_next, shard)
        return x_next.copy_(z.unsqueeze(0).expand_as(x_next))

    def finish(state, z_next, new_opt, new_res, t, losses, eta):
        # every model rank of an agent block computed the same losses: the
        # sum runs over the agents group only
        total = _sum_over_ranks(losses.sum().reshape(1), shard)
        return base.finish(state, z_next, new_opt, new_res, t,
                           total / n_agents, eta)

    return dataclasses.replace(base, gossip=gossip, ef_gossip=ef_gossip,
                               server=server, finish=finish,
                               fused_update_gossip=None)


def _sharded_spec(cfg, mesh, axis_name, model_axis):
    """The reference's spec of the sharded makers (repro/core/sharded.py:
    715-722): M from the mesh's model dim (which must exist); the rest of
    the model-axis checks run once, where the lowering places this rank
    (_shard_of)."""
    return engine.parse_engine_spec(
        cfg, layout="flat", n_shards=agent_axis_size(mesh, axis_name),
        axis_name=axis_name,
        n_model_shards=(_model_axis_size(mesh, model_axis)
                        if model_axis is not None else 1),
        model_axis=model_axis if model_axis is not None else "model")


def make_sharded_feddec_step(cfg: FedDecConfig, spec: FlatSpec,
                             grad_fn: engine.GradFn, lr_fn: LrFn, mesh, *,
                             device, axis_name="agents", optimizer=None,
                             model_axis=None):
    """One-iteration sharded executor (repro/core/sharded.py:698-725):
    ``step(state_blk, batch_blk, draws)`` on this rank's block of a
    FlatFedState (:func:`shard_flat_state`), batch leaves (n_local, ...).
    Every rank of the mesh calls it together, with draws of the same seed.
    With ``model_axis`` naming a mesh dim of size M > 1 the D dim is
    column-sharded over it too (the state placed by
    ``shard_flat_state(..., model_axis=...)``): the 2-D engine, whose
    batch block is the same on every model rank of an agent block.  A
    shim over :func:`engine.make_engine_step`."""
    return engine.make_engine_step(
        _sharded_spec(cfg, mesh, axis_name, model_axis), grad_fn,
        lr_fn, device=device, flat_spec=spec, mesh=mesh, optimizer=optimizer)


def make_sharded_feddec_round(cfg: FedDecConfig, spec: FlatSpec,
                              grad_fn: engine.GradFn, lr_fn: LrFn, mesh, *,
                              device, axis_name="agents", optimizer=None,
                              model_axis=None):
    """The sharded round (repro/core/sharded.py:776-810):
    ``round_fn(state_blk, batches_blk, draws)``, batch leaves (H, n_local,
    ...), metrics stacked to (H,).  The per-step collectives (the dense
    reduce-scatter or the halo, the server's and the loss's all-reduce;
    on the 2-D mesh also line 4's column gather and int8's scale maximum
    over the model group) are the only traffic between ranks.  A shim
    over :func:`engine.make_engine_round`."""
    return engine.make_engine_round(
        _sharded_spec(cfg, mesh, axis_name, model_axis), grad_fn,
        lr_fn, device=device, flat_spec=spec, mesh=mesh, optimizer=optimizer)


# ---------------------------------------------------------------------------
# The sharded R-run lattice (repro/core/engine.py:693-1145)
# ---------------------------------------------------------------------------


def _union_support_graph(plan) -> topo.Graph:
    """OR of every non-FedAvg run's mixing support: the lattice shares one
    halo schedule, exact for every run (a run without a given cut edge
    multiplies the received block by zeros)."""
    n = plan.n_agents
    adj = np.zeros((n, n), dtype=bool)
    for c, nm in zip(plan.configs, plan.none_mask):
        if not nm:
            adj |= np.asarray(c.mixing.graph.adjacency)
    return topo.Graph(adj, name="sweep-union")


def _make_sweep_shard_mixer(plan, shard: _Shard, compressor=None):
    """Per-shard whole-lattice mixer: mix(w (R, n, n), x_blk (R, n_local,
    D)) -> y_blk, or with a codec mix(w, p_blk, s_blk, payload) -> y_blk
    (repro/core/engine.py:741-866).  Dense reduce-scatters the (R, n, D)
    partial over the agent dim; the halo moves the whole (R, n_local, D)
    block (or its encoded payload) each round of the union quotient's
    schedule, the own block and every round's sub-block through kernel
    #5 under 'pallas'."""
    impl = plan.gossip_impl
    lo, nl, rows = shard.lo, shard.n_local, shard.rows

    def reduce_scatter(partial, like):
        if shard.n_shards == 1:
            return partial
        # the agent dim leads for the collective: (n, R, D) → (n_local, R, D)
        out = torch.empty_like(like.transpose(0, 1), memory_format=torch
                               .contiguous_format)
        _reduce_scatter(out, partial.transpose(0, 1).contiguous(),
                        group=shard.group)
        return out.transpose(0, 1).contiguous()

    def diag_blk(w, dtype):
        return torch.diagonal(w, dim1=1, dim2=2)[:, rows].to(dtype)[..., None]

    def ef_term(w, p_blk, s_blk):
        return torch.sub(p_blk, s_blk).mul_(diag_blk(w, p_blk.dtype))

    if impl == "none":
        return lambda w, x_blk: x_blk

    if impl == "dense":
        if compressor is None:
            return lambda w, x_blk: reduce_scatter(
                gossip_lib.gossip_mix_dense(w[:, :, rows], x_blk), x_blk)
        return lambda w, p_blk, s_blk, payload: reduce_scatter(
            gossip_lib.gossip_mix_dense(w[:, :, rows], s_blk), s_blk).add_(
            ef_term(w, p_blk, s_blk))

    if impl in ("sparse", "pallas"):
        perms, _ = _halo_setup(_union_support_graph(plan), shard.n_shards)
        halo = _Halo(shard, perms)
        blk_mix = _blk_mix_for(impl)

        def halo_mix(w, x_blk, send, decode):
            received, works = halo.post(send)
            y = blk_mix(w[:, rows, lo:lo + nl], x_blk)
            _wait(works)
            for src, recv in zip(halo.srcs, received):
                if recv is not None:
                    y.add_(blk_mix(w[:, rows, src * nl:(src + 1) * nl],
                                   decode(recv)))
            return y

        if compressor is None:
            return lambda w, x_blk: halo_mix(w, x_blk, x_blk, lambda r: r)

        def cmix(w, p_blk, s_blk, payload):
            # the halo moves the encoded payload, leaf by leaf
            return halo_mix(w, s_blk, payload, lambda recv: compressor.decode(
                recv, p_blk.dtype, p_blk.shape[-1])).add_(
                ef_term(w, p_blk, s_blk))
        return cmix

    raise engine.unknown_gossip_impl(impl)


def _sweep_shard_ops(plan, spec: FlatSpec, grad_fn: engine.GradFn,
                     lr_fn: LrFn, mesh, axis_name, optimizer,
                     device) -> engine.EngineOps:
    """The sharded lattice's vtable (repro/core/engine.py:899-1010): the
    sweep engine's ops on this rank's (R, n_local, D) block, with the
    gossip, the server round and the loss made collective."""
    from repro_torch.core import sweep as sweep_lib
    device = _check_mesh_device(mesh, device)
    shard = _shard_of(mesh, axis_name, plan.n_agents)
    n = plan.n_agents
    base = sweep_lib._sweep_ops(plan, spec, grad_fn, lr_fn, optimizer,
                                device)
    compressor = sweep_lib._compressor(plan)
    fedavg = np.flatnonzero(plan.none_mask)
    mixer = _make_sweep_shard_mixer(plan, shard, compressor)
    ef_gossip = None
    if compressor is not None:
        def ef_gossip(w, x_half, res_blk, draws, t):
            payload, s_blk, new_res = _encode_shard_block(
                compressor, draws, t, n, shard, x_half, res_blk)
            y = mixer(w, x_half, s_blk, payload)
            # FedAvg members exchange nothing: their rows are put back
            # (repro/core/engine.py:978-983)
            for r in fedavg:
                y[r].copy_(x_half[r])
                new_res[r].copy_(res_blk[r])
            return y, new_res

    def server(draws, t, x_next):
        # every run draws its K participants at every step, as on the
        # sweep engine; the fired runs' z is one all-reduce
        if not plan.server_enabled:
            return x_next
        idx = draws.participants(t, n, plan.k).to(x_next.device)
        counts = torch.zeros((plan.r_runs, n), dtype=torch.int32,
                             device=x_next.device)
        counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        weights = server_lib.participant_weights(counts, plan.k)
        fire = np.flatnonzero((t + 1) % plan.h == 0)
        if not len(fire):
            return x_next
        z = torch.stack([
            torch.matmul(weights[r, shard.rows].to(x_next.dtype), x_next[r])
            for r in fire])
        z = _sum_over_ranks(z, shard)
        for i, r in enumerate(fire):
            x_next[r].copy_(z[i].unsqueeze(0).expand_as(x_next[r]))
        return x_next

    def finish(state, z_next, new_opt, new_res, t, losses, eta):
        total = _sum_over_ranks(losses.sum(dim=1), shard)
        return base.finish(state, z_next, new_opt, new_res, t,
                           (total / n)[:, None], eta)

    return dataclasses.replace(
        base, gossip=mixer if compressor is None else base.gossip,
        ef_gossip=ef_gossip, server=server, finish=finish,
        fused_update_gossip=None)


def shard_sweep_state(state, mesh, axis_name="agents"):
    """This rank's (R, n_local, D) block of a SweepFedState, the agent dim
    block-sharded per run; the (R,) counters replicated
    (repro/core/engine.py:1034-1040)."""
    from repro_torch.core.sweep import SweepFedState
    n = state.flat.shape[1]
    shard = _shard_of(mesh, axis_name, n)

    def blk(t):
        return _block(t, shard.rows, 1, n)

    return SweepFedState(flat=blk(state.flat), step=np.array(state.step),
                         opt_state=tree_map(blk, state.opt_state),
                         residual=tree_map(blk, state.residual))


def gather_sweep_state(state_blk, mesh, axis_name="agents"):
    """The whole SweepFedState from every rank's block, on every rank."""
    from repro_torch.core.sweep import SweepFedState
    n = state_blk.flat.shape[1] * agent_axis_size(mesh, axis_name)
    shard = _shard_of(mesh, axis_name, n)

    def whole(t):
        return _gather_rows(t, shard, 1)

    return SweepFedState(flat=whole(state_blk.flat),
                         step=np.array(state_blk.step),
                         opt_state=tree_map(whole, state_blk.opt_state),
                         residual=tree_map(whole, state_blk.residual))


def make_sharded_sweep_step(plan, spec: FlatSpec, grad_fn: engine.GradFn,
                            lr_fn: LrFn, mesh, *, device, axis_name="agents",
                            optimizer=None):
    """One-iteration sharded-lattice executor (repro/core/engine.py:
    1062-1094): ``step(state_blk, batch_blk, draws)`` advances all R runs
    of this rank's (R, n_local, D) block by one step; batch leaves
    (R, n_local, ...); ``draws`` the lattice's (core/draws.py:
    SweepDraws)."""
    return engine.build_step_body(_sweep_shard_ops(
        plan, spec, grad_fn, lr_fn, mesh, axis_name, optimizer, device))


def make_sharded_sweep_round(plan, spec: FlatSpec, grad_fn: engine.GradFn,
                             lr_fn: LrFn, mesh, *, device,
                             axis_name="agents", optimizer=None,
                             metrics_fn=None, per_step_keys: bool = False):
    """The sharded-lattice round (repro/core/engine.py:1097-1145): T steps
    × R runs per call on this rank's block, batch leaves (T, R, n_local,
    ...), metrics stacked to (T, R); ``metrics_fn`` sees this rank's
    block state.  ``per_step_keys`` raises, as on the sweep engine: a
    RoundDraws re-keys the runs."""
    if per_step_keys:
        raise ValueError("per_step_keys (a (T, R) key array per round) is "
                         "not ported as a key table: pass a "
                         "repro_torch.core.draws.RoundDraws as the draws, "
                         "which re-keys every run at each of its server "
                         "rounds")
    return engine.make_loop_round(
        make_sharded_sweep_step(plan, spec, grad_fn, lr_fn, mesh,
                                device=device, axis_name=axis_name,
                                optimizer=optimizer), metrics_fn)
