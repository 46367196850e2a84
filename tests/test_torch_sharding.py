"""The port's shape-only init and partition specs against the reference.

``Model.init_shapes`` (the port's ``jax.eval_shape(model.init, key)``) is
held to the reference's parameter tree leaf by leaf (path, shape, dtype)
for every zoo config at full width; ``repro_torch.sharding``'s specs
(``param_pspecs`` on the stacked tree of ``n_agents_for`` agents,
``serve_param_pspecs``, ``batch_pspecs`` of train and decode batches,
``cache_pspecs`` of the decode_32k and long_500k caches) equal
``tuple(P(...))`` of the reference's, leaf by leaf, at the 16×16 and
2×16×16 meshes; the reference's ``_assign`` cases
(tests/test_sharding_analysis.py) and its layout checks hold on the
port's rules.  All of it is shape-only: nothing is allocated.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import sharding as rshd
from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import specs as ref_specs
from repro.models import build_model as ref_build
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import specs as port_specs
from repro_torch.models import build_model
from repro_torch.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {"16x16": (("data",), {"data": 16, "model": 16}),
          "2x16x16": (("pod", "data"), {"pod": 2, "data": 16,
                                        "model": 16})}


def _axes(mod, mesh: str):
    names, sizes = MESHES[mesh]
    return mod.MeshAxes(names, "model", dict(sizes))


def _ref_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): v for path, v in flat}


def _port_leaves(tree, prefix=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (str(k),)))
    else:
        out[prefix] = tree
    return out


def _ref_specs(tree) -> dict:
    return {k: tuple(v) for k, v in _ref_leaves(
        tree, is_leaf=lambda x: isinstance(x, P)).items()}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_init_shapes_equal_the_reference_eval_shape(arch):
    want = _ref_leaves(jax.eval_shape(ref_build(ref_config(arch)).init,
                                      jax.random.key(0)))
    got = _port_leaves(build_model(get_config(arch)).init_shapes())
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert _dtype_name(leaf.dtype) == _dtype_name(want[path].dtype), path


def _stacked(tree, n: int):
    return tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"), tree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    """Stacked (n_agents_for agents) and serving parameter specs."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    raxes, axes = _axes(rshd, mesh), _axes(shd, mesh)
    n = rshd.n_agents_for(rcfg, raxes)
    assert shd.n_agents_for(cfg, axes) == n
    rparams = jax.eval_shape(ref_build(rcfg).init, jax.random.key(0))
    rstacked = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct((n,) + l.shape, l.dtype), rparams)
    params = build_model(cfg).init_shapes()
    for want, got in (
            (rshd.param_pspecs(rcfg, rstacked, raxes),
             shd.param_pspecs(cfg, _stacked(params, n), axes)),
            (rshd.serve_param_pspecs(rcfg, rparams, raxes),
             shd.serve_param_pspecs(cfg, params, axes))):
        assert _port_leaves(got) == _ref_specs(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    """Train batches (stacked over the agents), decode batches, and the
    decode_32k and long_500k caches (bf16 serving config, as the
    reference's decode step builds them)."""
    rcfg, cfg = ref_config(arch), get_config(arch)
    raxes, axes = _axes(rshd, mesh), _axes(shd, mesh)
    n = rshd.n_agents_for(rcfg, raxes)
    train = REF_SHAPES["train_4k"]
    want = rshd.batch_pspecs(rcfg, ref_specs.train_batch_specs(
        rcfg, train, n), raxes, stacked=True)
    got = shd.batch_pspecs(cfg, port_specs.train_batch_specs(
        cfg, SHAPES["train_4k"], n), axes, stacked=True)
    assert _port_leaves(got) == _ref_specs(want)
    rcfg = dataclasses.replace(rcfg, param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    for name in ("decode_32k", "long_500k"):
        rshape, shape = REF_SHAPES[name], SHAPES[name]
        want = rshd.batch_pspecs(rcfg, ref_specs.decode_batch_specs(
            rcfg, rshape), raxes, stacked=False)
        got = shd.batch_pspecs(cfg, port_specs.decode_batch_specs(
            cfg, shape), axes, stacked=False)
        assert _port_leaves(got) == _ref_specs(want)
        long_variant = shape.needs_subquadratic
        rcaches = jax.eval_shape(lambda: ref_build(rcfg).init_caches(
            rshape.global_batch, rshape.seq_len, long_variant=long_variant))
        caches = build_model(cfg).init_caches(
            shape.global_batch, shape.seq_len, long_variant=long_variant,
            device="meta")
        rleaves, leaves = _ref_leaves(rcaches), _port_leaves(caches)
        assert {k: tuple(v.shape) for k, v in leaves.items()} == \
            {k: tuple(v.shape) for k, v in rleaves.items()}
        assert _port_leaves(shd.cache_pspecs(cfg, caches, axes)) == \
            _ref_specs(rshd.cache_pspecs(rcfg, rcaches, raxes))


SIZES = {"data": 16, "model": 16}


@pytest.mark.parametrize("shape,prefs,fallback,want", [
    # 20 % 16 fails: falls to dim 1 (the preference order, divisibility)
    ((20, 64), [(0, "model"), (1, "model")], [], (None, "model")),
    # no preference: the fallback takes the largest divisible dim
    ((32, 128), [], ["model"], (None, "model")),
    # one axis is used once; a tuple of axes counts their product
    ((32, 32), [(0, "model"), (1, "model")], [], ("model", None)),
    ((512, 7), [(0, ("data", "model"))], [], (("data", "model"), None)),
    # the largest dim does not divide: the next one takes it
    ((100, 48, 3), [], ["data"], (None, "data", None)),
])
def test_assign_cases(shape, prefs, fallback, want):
    assert shd._assign(SIZES, shape, prefs, fallback) == want
    rshd._with_sizes(rshd.MeshAxes(("data",), "model", dict(SIZES)))
    assert tuple(rshd._assign(shape, prefs, fallback)) == want


def test_layouts_and_gqa_small_kv_replication():
    """tests/test_sharding_analysis.py's layout checks on the port: the
    sharded layout's agent dim on 'data', the replicated layout's agent
    dim whole, every assignment dividing its dim, and Mistral's 8 KV
    heads (< 16) kept off 'model' while its 96 query heads shard."""
    axes = _axes(shd, "16x16")
    for arch, agent_ax in (("gemma3-12b", "data"),
                           ("deepseek-v3-671b", None)):
        cfg = get_config(arch)
        n = shd.n_agents_for(cfg, axes)
        params = _stacked(build_model(cfg).init_shapes(), n)
        specs = _port_leaves(shd.param_pspecs(cfg, params, axes))
        leaves = _port_leaves(params)
        for path, spec in specs.items():
            assert spec[0] == agent_ax, (arch, path, spec)
            for dim, ax in enumerate(spec):
                if ax is not None:
                    size = int(np.prod([axes.sizes[a] for a in
                                        (ax if isinstance(ax, tuple)
                                         else (ax,))]))
                    assert leaves[path].shape[dim] % size == 0
    cfg = get_config("mistral-large-123b")
    specs = shd.serve_param_pspecs(cfg, build_model(cfg).init_shapes(),
                                   axes)
    attn = specs["stack"]["scan"]["sub_0"]["attn"]
    assert "model" not in attn["wk"]["w"] and "model" in attn["wq"]["w"]


def test_placements_over_a_device_mesh():
    """A spec's placements: Shard(d) on each mesh dim a tensor dim names
    (alone or in a tuple), Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    @dataclasses.dataclass
    class Mesh:
        mesh_dim_names: tuple

    mesh = Mesh(("pod", "data", "model"))
    assert shd.placements(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.placements(mesh, (None, "data")) == [Replicate(), Shard(1),
                                                    Replicate()]
    assert shd.placements(mesh, ()) == [Replicate()] * 3
