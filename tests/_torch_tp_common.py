"""What the tensor-parallel model tests (``tests/test_torch_tp_*.py``)
share: the spawned 4-rank gloo world's meshes, the tree round's setting
(n 4, ring k 1, Metropolis with link failures p 0.1, H 2, K 2, 2 steps,
batch 1 × 16 tokens, η 0.05) and its draws' tables, and the helpers that
cut a tree into a rank's blocks and put it back together.  The spawned
ranks import this module through their test module: it imports no jax.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.core import feddec
from repro_torch.core import topology as topo
from repro_torch.core.mixing import MixingDistribution
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import tp
from repro_torch.tree import tree_map

WORLD = 4
MESHES = ((1, 2), (2, 2), (1, 4))
TOL, LOGIT_TOL = 1e-5, 1e-4
N, H, K, T, B, S, LR, P_FAIL = 4, 2, 2, 2, 1, 16, 0.05, 0.1
IMPLS = ("dense", "pallas", "sparse")


def axes(a: int, m: int) -> shd.MeshAxes:
    return shd.MeshAxes(("agents",), "model", {"agents": a, "model": m})


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                    tree)


def to_numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


class TableDraws:
    """Every rank's draws of W's links and the server's participants,
    served from tables the parent drew (keyed by the step t)."""

    def __init__(self, tables):
        self.tables = tables

    def link_uniforms(self, t, n):
        return torch.from_numpy(self.tables["links"][int(t)])

    def participants(self, t, n, k):
        return torch.from_numpy(self.tables["parts"][int(t)])


def tables() -> dict:
    rng = np.random.default_rng(11)
    return {"parts": {t: rng.integers(0, N, K) for t in range(1, T + 1)},
            "links": {t: rng.random((N, N)).astype(np.float32)
                      for t in range(1, T + 1)}}


def fed_mesh(a: int, m: int):
    """The (a, m) ('agents', 'model') mesh of the world, or with fewer
    ranks a slice of a 3-D mesh whose replicas run it side by side."""
    import torch.distributed as dist
    if a * m == dist.get_world_size():
        return mesh_lib.make_fed_mesh(a, m, device="cpu")
    from torch.distributed.device_mesh import init_device_mesh
    rep = dist.get_world_size() // (a * m)
    return init_device_mesh("cpu", (rep, a, m), mesh_dim_names=(
        "rep", "agents", "model"))["agents", "model"]


def whole(tree, like, cfg, mesh):
    """An unstacked tree of this rank's blocks put together, placed as
    the whole tree ``like`` is."""
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], like),
                             tp.mesh_axes(mesh))
    return tree_map(lambda t: t[0], tp.gather_params(
        tree_map(lambda t: t[None], tree), specs, mesh))


def blocks(tree: dict, cfg, mesh) -> dict:
    """This rank's blocks of an unstacked tree."""
    stacked = tree_map(lambda a: a[None], tree)
    specs = shd.param_pspecs(cfg, stacked, tp.mesh_axes(mesh))
    return tree_map(lambda a: a[0], tp.shard_params(stacked, specs, mesh))


def round_setup(impl: str):
    return feddec.FedDecConfig(
        mixing=MixingDistribution(topo.ring_graph(N, k=1), p_fail=P_FAIL,
                                  scheme="metropolis"), h=H, k=K,
        gossip_impl=impl)


def start_state(start):
    params = to_torch(start)
    state = feddec.init_state(tree_map(lambda a: a[0], params), N)
    state.params = params
    return state


def wait_for(path: str, timeout: float = 300.0):
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def flat(tree) -> np.ndarray:
    if isinstance(tree, dict):
        return np.concatenate([flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).ravel()


def assert_close(got, want, tol):
    got, want = flat(got), flat(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{err:.3e} > {tol}·{scale:.3e}"
