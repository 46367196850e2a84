"""Tensor-parallel model compute over the model group of a 2-D
('agents', 'model') ``DeviceMesh`` (the reference leaves it to GSPMD,
which partitions each agent replica's compute over the mesh's model axis
from the placements of ``sharding.param_pspecs``).

Each parameter of a rank is its block of the stacked leaf, cut by the
leaf's spec (:func:`shard_params`; rank ``a·M + m`` sits at (a, m), as
``launch/mesh.make_fed_mesh`` orders it).  The M ranks of a model group
hold the same agents and the same batch, so an activation outside a
tensor-parallel region is the same on each of them (replicated), and the
model's layers (models/layers.py, attention.py, transformer.py,
model.py) move between replicated and partitioned values with Megatron's
conjugate pairs (Shoeybi et al., arXiv:1909.08053, §3):

  * :func:`copy_to`: identity forward, all-reduce backward, where a
    replicated value enters a partitioned computation (its gradient is
    partial on each rank);
  * :func:`reduce_from`: all-reduce forward, identity backward, where
    partial results leave it (the row-parallel output, whose downstream
    is replicated: the all-reduce in both directions of
    ``torch.distributed.nn.functional.all_reduce`` would multiply that
    gradient by M);
  * :func:`gather_from`: all-gather forward, reduce-scatter backward, for
    a sharded value that a partitioned computation wants whole (a weight
    gathered on use, a sequence block's keys): each rank's gradient of
    the whole is partial, and the reduce-scatter both sums and re-cuts it;
  * :func:`gather_whole`: all-gather forward, this rank's block of the
    gradient backward, where a partitioned result leaves for a replicated
    computation (the MoE router's logit columns, whose routing every rank
    repeats): each rank's gradient of the whole is whole already.

Every pair is a ``torch.autograd.Function`` with ``setup_context`` and a
``vmap`` staticmethod, so that line 4, ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the agent rows, runs ONE collective on
the whole batched tensor for every local agent at once.  Each backward
calls its conjugate, so the gradients' collectives batch too.  Sums of
bf16 or f16 values are taken in f32.

The model group is ambient, as the reference's mesh is: the engines
enter :func:`model_group` around line 4, and a model whose config names
``tp_axis_name`` finds it with :func:`active` (None without one, or for a
group of one rank: the plain single-device compute).  Which layer is
partitioned how follows from its block's shape against the config's
dims (:func:`weight_for`), so the layers need no spec of their own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.sharding import MeshAxes

__all__ = ["ModelGroup", "model_group", "active", "copy_to", "reduce_from",
           "gather_from", "gather_whole", "all_reduce_max", "weight_for",
           "local_parts", "mesh_axes",
           "block_at", "block_of", "shard_params", "gather_params",
           "block_numel", "check_family"]

# torch 2.13 names the tensor forms *_single and deprecates the old names
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """One model group: its process group, this rank's coordinate on the
    model dim and the dim's size M."""

    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, mesh, axis: str = "model") -> "ModelGroup":
        return cls(mesh.get_group(axis), int(mesh.get_local_rank(axis)),
                   int(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[axis]))


_ACTIVE: dict = {}


@contextlib.contextmanager
def model_group(mesh, axis: str = "model"):
    """The model group of ``mesh``'s dim ``axis`` made ambient (the
    reference's ``jax.set_mesh``) for the model layers run inside."""
    prev = _ACTIVE.get(axis)
    _ACTIVE[axis] = ModelGroup.of(mesh, axis)
    try:
        yield _ACTIVE[axis]
    finally:
        if prev is None:
            _ACTIVE.pop(axis, None)
        else:
            _ACTIVE[axis] = prev


def active(axis_name) -> ModelGroup | None:
    """The ambient model group of ``axis_name`` when it has more than one
    rank, else None (a config without ``tp_axis_name``, no ambient
    group, or M = 1: the plain compute)."""
    if axis_name is None:
        return None
    g = _ACTIVE.get(axis_name)
    return g if g is not None and g.size > 1 else None


# ---------------------------------------------------------------------------
# the conjugate pairs
# ---------------------------------------------------------------------------


def _done(work) -> None:
    """Wait for a collective.  gloo completes a reduce-scatter in
    ``wait()`` with a split and a copy of its own (it runs it as an
    all-reduce): the backend's ops, not the program's, which NCCL and
    the dry run's fake backend do not issue, so a dispatch-mode tally
    (launch/trace_analysis.py) is kept from seeing them."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        work.wait()


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype its sum is taken in: f32 for bf16 and f16."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _all_reduce(x: torch.Tensor, g: ModelGroup, op=dist.ReduceOp.SUM):
    y = _wide(x).clone(memory_format=torch.contiguous_format)
    _done(dist.all_reduce(y, op=op, group=g.group, async_op=True))
    return y.to(x.dtype)


def _gather(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    blk = x.movedim(dim, 0).contiguous()
    out = blk.new_empty((g.size * blk.shape[0],) + blk.shape[1:])
    _done(_all_gather(out, blk, group=g.group, async_op=True))
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    full = _wide(x).movedim(dim, 0).contiguous()
    out = full.new_empty((full.shape[0] // g.size,) + full.shape[1:])
    _done(_reduce_scatter(out, full, group=g.group, async_op=True))
    return out.movedim(0, dim).to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x, g):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFrom.apply(grad, ctx.g), None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _CopyTo.apply(x, g), in_dims[0]


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, g):
        return _all_reduce(x, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _CopyTo.apply(grad, ctx.g), None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _ReduceFrom.apply(x, g), in_dims[0]


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, g, dim):
        return _gather(x, g, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _ScatterSum.apply(grad, ctx.g, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, g, dim):
        return _GatherFrom.apply(x.movedim(in_dims[0], 0), g, dim + 1), 0


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(x, g, dim):
        return _scatter_sum(x, g, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _GatherFrom.apply(grad, ctx.g, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, g, dim):
        return _ScatterSum.apply(x.movedim(in_dims[0], 0), g, dim + 1), 0


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(x, g, dim):
        return _gather(x, g, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.g, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        size = grad.shape[ctx.dim] // ctx.g.size
        return grad.narrow(ctx.dim, ctx.g.rank * size, size), None, None

    @staticmethod
    def vmap(info, in_dims, x, g, dim):
        return _GatherWhole.apply(x.movedim(in_dims[0], 0), g, dim + 1), 0


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(x, g):
        return _all_reduce(x, g, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _AllReduceMax.apply(x, g), in_dims[0]


def copy_to(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward over the model group."""
    return _CopyTo.apply(x, g)


def reduce_from(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward over the model group."""
    return _ReduceFrom.apply(x, g)


def gather_from(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """The model group's blocks of x along ``dim`` put together
    (all-gather), and in the backward the gradient summed over the group
    and cut back to this rank's block (reduce-scatter)."""
    return _GatherFrom.apply(x, g, dim % x.ndim)


def gather_whole(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """The model group's blocks of x along ``dim`` put together
    (all-gather) for a replicated computation, and in the backward this
    rank's block of the gradient (each rank's is whole already)."""
    return _GatherWhole.apply(x, g, dim % x.ndim)


def all_reduce_max(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """The elementwise maximum over the model group (no gradient)."""
    return _AllReduceMax.apply(x.detach(), g)


def weight_for(w: torch.Tensor, full_shape: tuple, g: ModelGroup,
               part_dim: int | None = None) -> torch.Tensor:
    """A parameter block as a partitioned computation wants it: this
    rank's part along ``part_dim`` (its M-th of that dim), or with
    ``part_dim`` None the whole weight.

    The block is used as it is when it is already that part; a
    replicated weight goes through :func:`copy_to` (its gradient, partial
    on each rank, is summed) and a weight sharded on another dim through
    :func:`gather_from` (the partial gradients summed and re-cut), and
    then the part is cut out.  Only a partitioned computation may take a
    weight so: in one replicated over the group every rank's gradient is
    whole, and the sums would count it M times."""
    sharded = [d for d in range(w.ndim) if w.shape[d] != full_shape[d]]
    if part_dim is not None and sharded == [part_dim]:
        return w
    if not sharded:
        w = copy_to(w, g)
    elif len(sharded) == 1:
        w = gather_from(w, g, sharded[0])
    else:
        raise ValueError(f"a block {tuple(w.shape)} of {tuple(full_shape)} "
                         f"sharded on more than one dim")
    if part_dim is None:
        return w
    size = full_shape[part_dim] // g.size
    return w.narrow(part_dim, g.rank * size, size)


def local_parts(x: torch.Tensor, sizes: tuple, g: ModelGroup, dim: int,
                whole: tuple = ()) -> list:
    """The parts of a whole ``x`` that is ``sizes`` concatenated along
    ``dim`` (Mamba2's ``in_proj`` columns [z, x, B, C, dt], its conv's
    channels [x, B, C]), as this rank computes with them: each part's
    M-th block at this rank's coordinate, or the part whole where its
    index is in ``whole``.  ``param_pspecs`` cuts such a dim contiguously,
    so a rank's block of it is not its part of each: gather the dim first
    (:func:`gather_from`, :func:`weight_for`), then cut it here."""
    out, start = [], 0
    for i, size in enumerate(sizes):
        if i in whole:
            out.append(x.narrow(dim, start, size))
        else:
            if size % g.size:
                raise ValueError(f"a part of {size} over {g.size} model "
                                 f"ranks")
            block = size // g.size
            out.append(x.narrow(dim, start + g.rank * block, block))
        start += size
    if start != x.shape[dim]:
        raise ValueError(f"parts {tuple(sizes)} do not make up dim {dim} "
                         f"of {tuple(x.shape)}")
    return out


# ---------------------------------------------------------------------------
# placement: a rank's blocks of a stacked tree
# ---------------------------------------------------------------------------


def mesh_axes(mesh, agent_axis: str = "agents",
              model_axis: str = "model") -> MeshAxes:
    """The roles of a launch/mesh.make_fed_mesh mesh for
    ``sharding.param_pspecs``: the agents on ``agent_axis``, the
    tensor-parallel dim on ``model_axis``; the specs then name the mesh's
    own dims."""
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))
    sizes.setdefault(model_axis, 1)
    return MeshAxes((agent_axis,), model_axis, sizes)


def _mesh_coords(mesh) -> dict:
    """{dim name: (this rank's coordinate, the dim's size)} of a mesh."""
    return {name: (int(mesh.get_local_rank(name)), int(size))
            for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def _coords(coords: dict, spec: tuple) -> list:
    """(dim, coordinate, size, axis) of every sharded dim of ``spec``,
    whose axis names are the mesh's dims."""
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):
            raise NotImplementedError(
                f"a dim over several mesh axes {ax} is not ported: the "
                f"port's meshes have one agent dim")
        if ax not in coords:
            raise ValueError(f"spec {spec} names {ax!r}, which the mesh "
                             f"{tuple(coords)} lacks")
        out.append((d, *coords[ax], ax))
    return out


def block_at(leaf: torch.Tensor, spec: tuple,
             coords: dict) -> torch.Tensor:
    """The block of a whole stacked leaf at mesh ``coords`` ({dim name:
    (coordinate, size)}) by its spec, a tensor of its own (the leaf
    itself when the spec shards nothing)."""
    if len(spec) != leaf.ndim:
        raise ValueError(f"spec {spec} does not fit a leaf of shape "
                         f"{tuple(leaf.shape)}")
    cut = _coords(coords, spec)
    if not cut:
        return leaf
    for d, c, k, _ in cut:
        size = leaf.shape[d] // k
        leaf = leaf.narrow(d, c * size, size)
    return leaf.clone()


def block_of(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a whole stacked leaf by its spec."""
    return block_at(leaf, spec, _mesh_coords(mesh))


def shard_params(tree, specs, mesh, *, coords: dict | None = None):
    """This rank's blocks of a stacked tree (a tensor or a nested dict)
    by ``specs`` (``sharding.param_pspecs``'s tree of tuples, over the
    mesh's dim names): the port's counterpart of placing the tree with
    ``NamedSharding``.  With ``coords`` ({dim name: (coordinate, size)},
    ``mesh`` None) the blocks at those coordinates."""
    if coords is None:
        coords = _mesh_coords(mesh)
    if isinstance(tree, dict):
        return {k: shard_params(v, specs[k], None, coords=coords)
                for k, v in tree.items()}
    return block_at(tree, specs, coords)


def gather_params(tree_blk, specs, mesh):
    """The whole stacked tree from every rank's blocks, on every rank
    (one ``all_gather_into_tensor`` a sharded dim of a leaf, over that
    dim's group)."""
    if isinstance(tree_blk, dict):
        return {k: gather_params(v, specs[k], mesh)
                for k, v in tree_blk.items()}
    leaf = tree_blk
    for d, _, k, ax in _coords(_mesh_coords(mesh), specs):
        if k > 1:
            leaf = _gather(leaf, ModelGroup(mesh.get_group(ax), 0, k), d)
    return leaf.contiguous()


def block_numel(shape: tuple, spec: tuple, sizes: dict) -> int:
    """Elements of a rank's block of a leaf of ``shape`` under ``spec``."""
    n = math.prod(shape)
    for ax in spec:
        if ax is not None:
            n //= sizes[ax]
    return n


# ---------------------------------------------------------------------------
# the ported families
# ---------------------------------------------------------------------------


def check_family(cfg) -> None:
    """Raise NotImplementedError for a config whose tensor-parallel
    compute is not ported, naming the ROADMAP item (Queue A item 6) that
    ports it.  Every model of the ``sharded`` agent layout passes: GQA or
    MLA attention (RoPE or M-RoPE) with a dense MLP or an MoE, Mamba2's
    SSD blocks, RecurrentGemma's RG-LRU blocks, Qwen2-VL's vision prefix
    and SeamlessM4T's encoder stack and cross-attention.  The
    ``replicated`` layout's FSDP over the data axes is item 6.4."""
    if cfg.fed_agent_layout != "replicated":
        return
    raise NotImplementedError(
        f"{cfg.name}: tensor-parallel compute over a model axis > 1 is not "
        f"ported for the 'replicated' agent layout's FSDP over the data "
        f"axes (ROADMAP.md Queue A item 6.4); the port does not fall back "
        f"to running the whole model on each rank")
