"""Device meshes of the sharded engine (repro/launch/mesh.py:31-85), on
``torch.distributed``.

The reference builds one controller's mesh over the devices it sees.  The
port runs one process per shard in one ``torch.distributed`` group (NCCL
where each rank has its card, gloo on the CPU), and its mesh is that
group's 1-D ``DeviceMesh``: rank r owns block r of the agent axis.  The
group comes first: ``torchrun --nproc-per-node N`` (or any
``init_process_group`` of world size N) and then :func:`make_agent_mesh`.

The reference's production meshes (``make_production_mesh``,
``make_host_mesh``) are the dry-run's and wait for ROADMAP Queue A item 5;
the 2-D ('agents', 'model') mesh waits for item 4's 2-D line.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_agent_mesh", "make_fed_mesh"]


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
    avail = dist.get_world_size() if dist.is_initialized() else 0
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
    """The reference's ('agents', 'model') mesh.  ``make_fed_mesh(A, 1)``
    lowers the 1-D engine (repro/launch/mesh.py:63-65): it is
    :func:`make_agent_mesh`.  A model axis of size M > 1, each agent
    replica's D dim column-sharded over M ranks, is not ported."""
    if n_agent_shards < 1 or n_model_shards < 1:
        raise ValueError(f"need n_agent_shards >= 1 and n_model_shards >= "
                         f"1, got ({n_agent_shards}, {n_model_shards})")
    if n_model_shards > 1:
        raise NotImplementedError(
            f"the 2-D ('{agent_axis}', '{model_axis}') mesh (n_model_shards "
            f"= {n_model_shards} > 1) is not ported to repro_torch yet; see "
            f"ROADMAP.md Queue A item 4 (the 2-D agents x model line)")
    return make_agent_mesh(n_agent_shards, agent_axis, device=device)
