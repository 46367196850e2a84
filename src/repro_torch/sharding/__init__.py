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
dim names and sizes.  The reference's partition specs (``param_pspecs``,
``serve_param_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
``named_shardings``) place leaves for XLA's partitioner and have no
counterpart here yet (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshAxes", "axes_for_mesh", "n_agents_for"]


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
