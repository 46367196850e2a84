"""Device meshes of the sharded engine (repro/launch/mesh.py:31-85), on
``torch.distributed``.

The reference builds one controller's mesh over the devices it sees.  The
port runs one process per shard in one ``torch.distributed`` group (NCCL
where each rank has its card, gloo on the CPU), and its mesh is a
``DeviceMesh`` over that group's ranks: the 1-D ``("agents",)`` mesh of
:func:`make_agent_mesh`, rank r owning block r of the agent axis, or the
2-D ``("agents", "model")`` mesh of :func:`make_fed_mesh`, rank
``a·M + m`` owning agent block a and column block m (the reference's
row-major device order, which the collective-axis classifier of
launch/trace_analysis.py decodes group ranks against).  The group comes
first: ``torchrun --nproc-per-node N`` (or any ``init_process_group`` of
world size N) and then the mesh.

The reference's production meshes (``make_production_mesh``,
``make_host_mesh``) name the dry run's mesh, whose roles live in
``sharding.MeshAxes`` here (launch/dryrun.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_agent_mesh", "make_fed_mesh"]


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_agent_mesh(n_shards: int, axis_name: str = "agents", *,
                    device="cuda"):
    """1-D mesh for the sharded flat engine (core/sharded.py).

    The flat (n_agents, D) buffer is block-sharded over this single dim:
    each rank owns n_agents/n_shards whole agent rows.  ``device`` is the
    device type of the ranks' blocks: 'cuda' (each rank on its own card,
    NCCL) unless the caller asks for 'cpu' (gloo).  Needs an initialized
    process group of exactly ``n_shards`` ranks.
    """
    device_type = torch.device(device).type
    avail = _world()
    if not 1 <= n_shards <= avail or n_shards != avail:
        raise ValueError(
            f"need 1 <= n_shards <= {avail} ranks of the initialized "
            f"process group, and all of them, got {n_shards} (start one "
            f"process per shard: torchrun --nproc-per-node {n_shards}, "
            f"or init_process_group with world_size={n_shards})")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_shards,),
                            mesh_dim_names=(axis_name,))


def make_fed_mesh(n_agent_shards: int, n_model_shards: int = 1,
                  agent_axis: str = "agents", model_axis: str = "model", *,
                  device="cuda"):
    """2-D (``agent_axis``, ``model_axis``) mesh for the model-sharded
    flat engine (repro/launch/mesh.py:51-85).

    The flat (n_agents, D) buffer is block-sharded over ``agent_axis``
    (n_agents/A whole rows a mesh row) and column-sharded over
    ``model_axis`` (each rank owns a D/M slice of its rows), so per-rank
    state scales as 1/(A·M).  Gossip and server collectives run over the
    agent dim only (core/sharded.py).  Rank ``a·M + m`` sits at (a, m):
    ``mesh.mesh`` is ``arange(A·M).reshape(A, M)``.  ``make_fed_mesh(A,
    1)`` covers the ranks of :func:`make_agent_mesh` in the same order
    with a model dim of size 1 appended, and the 1-D engine lowers on it
    unchanged.  Needs an initialized process group of exactly A·M ranks
    (``torchrun --nproc-per-node A·M``); ``device`` as in
    :func:`make_agent_mesh`.
    """
    avail = _world()
    if n_agent_shards < 1 or n_model_shards < 1 \
            or n_agent_shards * n_model_shards != avail:
        raise ValueError(
            f"need n_agent_shards >= 1, n_model_shards >= 1 and "
            f"n_agent_shards * n_model_shards == {avail} ranks of the "
            f"initialized process group, got ({n_agent_shards}, "
            f"{n_model_shards}) (start one process per (agent, model) "
            f"shard: torchrun --nproc-per-node "
            f"{max(n_agent_shards, 1) * max(n_model_shards, 1)})")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (n_agent_shards, n_model_shards),
                            mesh_dim_names=(agent_axis, model_axis))
