"""Mesh roles and the agent-count rule (repro/sharding/__init__.py:36-68).

The reference maps a production mesh's axes to roles (``MeshAxes``) and
derives the number of federated agents from an architecture's agent
layout (``n_agents_for``):

* ``sharded``    — one agent per slice of the data axes: n_agents is the
  product of their sizes (the training CLI builds a one-axis ``data`` mesh
  of ``--agents`` slices, so it trains ``--agents`` agents);
* ``replicated`` — ``fed_n_agents_replicated`` agents per pod, whatever
  the mesh (Mistral-Large-123B trains 4, DeepSeek-V3-671B 1).

``axes_for_mesh`` reads a ``torch.distributed.device_mesh.DeviceMesh``'s
dim names and sizes.

The partition specs (repro/sharding/__init__.py:76-313) map every
parameter, batch and cache leaf to a spec: a tuple with one entry per dim
of the leaf, each an axis name, a tuple of names or None, equal to
``tuple(P(...))`` of the reference's.  Name-based tensor-parallel rules
pick the Megatron dims (column-parallel wi/wq, row-parallel wo), and an
unmatched leaf falls back to its largest divisible dim; the rules match
on path names (``scan``, ``wk``, ``wo``, ``router``, ``in_proj``, the
cache leaves ``k``, ``v``, ``latent``, ``k_rope``, ``ssm``, ``conv``,
``h``, ``positions``, ``index``), which the port's trees carry at the
reference's depths.  The axis sizes come with the ``MeshAxes`` argument
(the reference keeps them in a module global).  The tree engine on the
('agents', 'model') mesh places each stacked leaf by
:func:`param_pspecs` (``sharding.tp.shard_params``) and partitions the
model's compute over the model group (sharding/tp.py); the dry run
records the specs beside the program it traces, and :func:`placements`
turns one into ``torch.distributed.tensor`` placements over a
``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["MeshAxes", "axes_for_mesh", "n_agents_for", "param_pspecs",
           "serve_param_pspecs", "batch_pspecs", "cache_pspecs",
           "placements", "map_with_path"]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Role assignment for a mesh's axes."""

    data_axes: tuple[str, ...]   # ('data',) or ('pod', 'data')
    model_axis: str              # 'model'
    sizes: dict[str, int]

    @property
    def data_size(self) -> int:
        return int(math.prod(self.sizes[a] for a in self.data_axes))

    @property
    def model_size(self) -> int:
        return self.sizes[self.model_axis]


def axes_for_mesh(mesh) -> MeshAxes:
    """The roles of a DeviceMesh's dims: ('pod', 'data') when it has a
    'pod' dim, else ('data',); 'model' is the model axis."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    if "pod" in names:
        return MeshAxes(("pod", "data"), "model", sizes)
    return MeshAxes(("data",), "model", sizes)


def n_agents_for(cfg, axes: MeshAxes) -> int:
    """Agent count implied by (arch layout × mesh).

    ``replicated`` counts are PER POD (cross-silo: a pod is a silo, so a
    multi-pod mesh multiplies the agent population).
    """
    if cfg.fed_agent_layout == "replicated":
        return cfg.fed_n_agents_replicated * axes.sizes.get("pod", 1)
    return axes.data_size


# ---------------------------------------------------------------------------
# divisibility-aware axis assignment (repro/sharding/__init__.py:76-122)
# ---------------------------------------------------------------------------


def _axis_names(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _assign(sizes: dict, shape: tuple, preferences: list,
            fallback_axes: list = ()) -> tuple:
    """A spec trying (dim, axis-or-axes) preferences in order.

    An assignment is taken only if the dim's size is divisible by the
    axis (product) size and neither the dim nor the axis is used yet;
    ``fallback_axes`` then go greedily to the largest unused divisible
    dim."""
    spec: list = [None] * len(shape)
    used: set = set()

    def axis_size(ax) -> int:
        return int(math.prod(sizes[a] for a in _axis_names(ax)))

    def try_assign(dim, ax) -> bool:
        if dim >= len(shape) or spec[dim] is not None:
            return False
        if any(a in used for a in _axis_names(ax)):
            return False
        if shape[dim] % axis_size(ax):
            return False
        spec[dim] = ax
        used.update(_axis_names(ax))
        return True

    for dim, ax in preferences:
        try_assign(dim, ax)
    for ax in fallback_axes:
        for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if try_assign(dim, ax):
                break
    return tuple(spec)


def _tp_preferences(names: list, shape: tuple, model: str, cfg,
                    sizes: dict) -> tuple[list, bool]:
    """(preferred (dim, axis) list, allow_fallback) of a parameter from
    its path names; dims index the parameter's own shape (agent and group
    dims are the caller's).  allow_fallback False pins an unmatched
    parameter to replication (GQA's small KV heads, as Megatron
    replicates them)."""
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    tp = sizes.get(model, 1)
    # embeddings / head
    if leaf == "table":                      # (vocab, d)
        return [(0, model), (1, model)], True
    if parent == "head":                     # w: (d, vocab)
        return [(1, model), (0, model)], True
    # attention
    if parent in ("wk", "wv") and len(shape) == 3:  # (d, KV, hd)
        if cfg is not None and cfg.num_kv_heads % tp == 0:
            return [(1, model)], False
        if cfg is not None and cfg.num_kv_heads < cfg.num_heads:
            return [], False                 # GQA: replicate small KV
        return [(0, model)], False           # MHA: d-shard
    if parent in ("wq", "wq_b", "wk_b", "wv_b"):
        return [(1, model), (0, model)], False  # (d|rank, H, hd) → heads
    if parent == "wo" and len(shape) == 3:   # (H, hd, d)
        return [(0, model), (2, model)], False
    if parent in ("wq_a", "wkv_a"):          # (d, rank): small, replicate
        return [], False
    # mlp
    if parent in ("wi", "wg") and len(shape) == 2:
        return [(1, model)], False           # column-parallel (d, ff)
    if parent == "wo" and len(shape) == 2:
        return [(0, model)], False           # row-parallel (ff, d)
    # moe
    if len(shape) == 3 and parent in ("wi", "wg", "wo"):
        return [(0, model)], False           # (E, d, f) expert-parallel
    if parent == "router":                   # (d, E)
        return [(1, model)], False
    # ssm
    if parent == "in_proj":
        return [(1, model)], False
    if parent == "out_proj":
        return [(0, model), (1, model)], False
    if leaf == "conv_w":                     # (K, C)
        return [(1, model)], False
    # rglru
    if parent in ("proj_gelu", "proj_rec"):  # (d, W)
        return [(1, model)], False
    if parent in ("w_a", "w_x"):             # (W, W)
        return [(1, model)], False
    # fallback: largest divisible dim over model
    if len(shape) >= 2:
        dims = sorted(range(len(shape)), key=lambda d: -shape[d])
        return [(d, model) for d in dims], True
    return [], False


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path names, leaf)`` over a nested dict (the port's parameter,
    batch and cache trees)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(list(path), tree)


def _agent_axis(axes: MeshAxes):
    return axes.data_axes if len(axes.data_axes) > 1 else axes.data_axes[0]


def param_pspecs(cfg, params_tree: Any, axes: MeshAxes) -> Any:
    """Specs of *stacked* federated parameters, leaves (agents, [groups],
    *dims) (a scanned group's leaves, under ``scan``, have the group
    dim): the sharded layout puts the agents on the data axes and the
    tensor-parallel dim on 'model'; the replicated layout leaves the
    agent dim whole and shards each agent FSDP-style over the data axes
    (never on the agent dim)."""
    sizes, model = dict(axes.sizes), axes.model_axis
    data = _agent_axis(axes)

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        lead = 1 + ("scan" in names)
        tp, _ = _tp_preferences(names, shape[lead:], model, cfg, sizes)
        prefs = [(d + lead, ax) for d, ax in tp]
        if cfg.fed_agent_layout == "sharded":
            return _assign(sizes, shape, [(0, data)] + prefs)
        spec = _assign(sizes, shape, prefs, fallback_axes=[data])
        return (None,) + spec[1:] if spec and spec[0] is not None else spec

    return map_with_path(rule, params_tree)


def serve_param_pspecs(cfg, params_tree: Any, axes: MeshAxes) -> Any:
    """Specs of *unstacked* serving parameters: tensor-parallel over
    'model', FSDP over the data axes."""
    sizes, model = dict(axes.sizes), axes.model_axis
    data = _agent_axis(axes)

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        lead = 1 if "scan" in names else 0
        tp, _ = _tp_preferences(names, shape[lead:], model, cfg, sizes)
        return _assign(sizes, shape, [(d + lead, ax) for d, ax in tp],
                       fallback_axes=[data])

    return map_with_path(rule, params_tree)


def batch_pspecs(cfg, batch_tree: Any, axes: MeshAxes, *,
                 stacked: bool) -> Any:
    """Specs of training batches ((agents, B, S) leaves, ``stacked``) or
    decode batches ((B, S) leaves); M-RoPE's positions carry their batch
    dim one deeper."""
    sizes, dp = dict(axes.sizes), _agent_axis(axes)

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        mrope = "mrope_positions" in names
        if stacked:
            if cfg.fed_agent_layout == "sharded":
                return _assign(sizes, shape, [(0, dp)])
            return _assign(sizes, shape, [(2 if mrope else 1, dp)])
        # decode: batch over data; the sequence for batch 1 long context
        return _assign(sizes, shape, [(1 if mrope else 0, dp)],
                       fallback_axes=[dp])

    return map_with_path(rule, batch_tree)


def cache_pspecs(cfg, cache_tree: Any, axes: MeshAxes) -> Any:
    """Specs of decode caches: batch over the data axes, KV heads over
    'model'; for batch 1 the time dim takes the fallback, so that a 500k
    cache does not replicate."""
    sizes, model, dp = dict(axes.sizes), axes.model_axis, _agent_axis(axes)

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        lead = 1 if "scan" in names else 0
        name = names[-1]
        if name in ("k", "v", "latent", "k_rope"):
            # ([G], B, T, KV, hd) / ([G], B, T, rank)
            return _assign(sizes, shape, [(lead, dp), (lead + 2, model),
                                          (lead + 1, model), (lead + 1, dp)])
        if name in ("ssm", "h"):            # ([G], B, H, P, N) / ([G], B, W)
            return _assign(sizes, shape, [(lead, dp), (lead + 1, model)])
        if name == "conv":                  # ([G], B, K-1, C)
            return _assign(sizes, shape, [(lead, dp), (lead + 2, model)])
        return (None,) * len(shape)

    return map_with_path(rule, cache_tree)


def placements(mesh, spec: tuple) -> list:
    """``torch.distributed.tensor`` placements of a spec over a
    ``DeviceMesh``: for each mesh dim, ``Shard(d)`` where tensor dim ``d``
    names it (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax is not None and name in _axis_names(ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
