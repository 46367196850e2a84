"""The port's dry run (launch/steps.py, launch/dryrun.py) and its kernels'
fakes (kernels/ops.py), against the reference where it has a
counterpart.

* Each kernel wrapper #1–#17 on meta tensors, and on fake CUDA tensors,
  reaches its custom op's fake: outputs shaped and typed as the plain
  version's on CPU tensors, and no launch counted.
* ``_microbatch_grad`` equals the reference's gradient accumulation on
  the tiny LM's smoke config (loss and gradients within 1e-5·max).
* Each ``build_*_lowerable``'s traced outputs (meta) are shaped as a real
  CPU run's of the same step; the sharded layout traces rank 0 of a fake
  world and counts its collectives; the argument checks give the
  reference's messages; the lowerables' partition specs equal the
  reference's leaf by leaf.
* ``run_one`` writes a record with the reference's keys mapped to the
  tally's and ``status: ok``; ``_model_flops`` equals the reference's
  (its source, read from repro/launch/dryrun.py: that module sets
  XLA_FLAGS when imported, so no test imports it).
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

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
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import build_model as ref_build
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import FedConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import flat as flat_lib
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps, train
from repro_torch.models import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

AXES16 = shd.MeshAxes(("data",), "model", {"data": 16, "model": 16})
REF_AXES16 = rshd.MeshAxes(("data",), "model", {"data": 16, "model": 16})


def _shapes(tree) -> list:
    """(shape, dtype) of every tensor of a step's inputs or outputs, in
    order (the engines' state dataclasses walked field by field)."""
    from repro_torch.launch.trace_analysis import _tensors
    return [(tuple(t.shape), t.dtype) for t in _tensors(tree)]


# ---------------------------------------------------------------------------
# the kernels' fakes
# ---------------------------------------------------------------------------


def _wrapper_call(name: str, device: str):
    """A small call of the wrapper ``name`` on ``device`` (the same shapes
    on each): random values on the CPU, none elsewhere (meta, or fake
    CUDA under a FakeTensorMode)."""
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        if device != "cpu":
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.randn(*shape, generator=g).to(dtype).abs()

    batched = name.endswith("_batched")
    lead = (2,) if batched else ()
    n, d = 6, 130
    x, gr, s, u, m = (rnd(*lead, n, d) for _ in range(5))
    w = rnd(*lead, n, n)
    if device == "cpu":
        nbr = torch.tensor([[(i + 1) % n, (i - 1) % n] for i in range(n)],
                           dtype=torch.int32).expand(*lead, n, 2)
        nbr = nbr.contiguous()
        q = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    else:
        nbr = rnd(*lead, n, 2, dtype=torch.int32)
        q = rnd(n, d, dtype=torch.int8)
    wv, wd = rnd(*lead, n, 2), rnd(*lead, n)
    eta = rnd(2 if batched else 1)
    scale = rnd(n) + 0.5
    base = name.removesuffix("_batched")
    fn = getattr(ops, name)
    if base == "gossip_mix":
        return fn(w, x)
    if base == "gossip_mix_sparse":
        return fn(nbr, wv, wd, x)
    if base == "update_mix":
        return fn(w, x, gr, eta, m, beta=0.9)
    if base == "update_mix_sparse":
        return fn(nbr, wv, wd, x, gr, eta)
    if base == "ef_mix":
        return fn(w, x, s, u)
    if base == "ef_mix_sparse":
        return fn(nbr, wv, wd, x, s, u)
    if name == "quant_mix":
        return fn(w, u, rnd(n, d) % 1, x, scale)
    if name == "dequant_mix":
        return fn(w, q, scale, x)
    with torch.no_grad():
        if name == "flash_attention":
            return fn(rnd(1, 70, 4, 64, dtype=torch.bfloat16),
                      rnd(1, 70, 2, 64, dtype=torch.bfloat16),
                      rnd(1, 70, 2, 64, dtype=torch.bfloat16), window=16)
        if name == "ssd_scan":
            return fn(rnd(1, 40, 3, 16), rnd(1, 40, 3), -rnd(3) - 0.5,
                      rnd(1, 40, 16), rnd(1, 40, 16))
        assert name == "rglru_scan"
        return fn(rnd(2, 33, 40) % 1, rnd(2, 33, 40))


@pytest.mark.parametrize("device", ["meta", "fake-cuda"])
@pytest.mark.parametrize("name", sorted(ops._OPS))
def test_kernel_fake_is_shaped_as_the_plain_version(name, device):
    """The wrapper on meta tensors, or on fake CUDA tensors under a
    FakeTensorMode (the card's route), reaches its op's fake: outputs of
    the plain version's shapes and dtypes on the fake's device, and no
    launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.trace_analysis import _tensors
    ops.reset_launch_counts()
    if device == "meta":
        fake = _wrapper_call(name, "meta")
    else:
        with FakeTensorMode():
            fake = _wrapper_call(name, "cuda")
    plain = _wrapper_call(name, "cpu")
    assert _shapes(fake) == _shapes(plain)
    want = "meta" if device == "meta" else "cuda"
    assert all(t.device.type == want for t in _tensors(fake))
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# _microbatch_grad against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro", [2, 4])
def test_microbatch_grad_equals_the_reference(micro):
    rcfg = ref_train.tiny_lm_config(64, 2, vocab=256)
    cfg = train.tiny_lm_config(64, 2, vocab=256)
    rmodel = ref_build(rcfg)
    params = jax.jit(rmodel.init)(jax.random.key(0))
    tparams = flat_lib.params_from_numpy(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(4, 16))
    positions = np.broadcast_to(np.arange(16), (4, 16))
    want_loss, want = ref_steps._microbatch_grad(rmodel.grad_fn(), micro)(
        params, {"tokens": jnp.asarray(tokens, jnp.int32),
                 "positions": jnp.asarray(positions, jnp.int32)},
        jax.random.key(0))
    loss, got = steps._microbatch_grad(build_model(cfg).grad_fn(), micro)(
        tparams, {"tokens": torch.from_numpy(tokens),
                  "positions": torch.from_numpy(positions.copy())})
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    ref_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in ref_leaves:
        node = got
        for k in path:
            node = node[k.key]
        want_np = np.asarray(leaf)
        assert node.dtype == torch.float32
        err = np.max(np.abs(node.numpy() - want_np))
        assert err <= 1e-5 * np.max(np.abs(want_np)), path


# ---------------------------------------------------------------------------
# the lowerables: traced outputs against a real CPU run
# ---------------------------------------------------------------------------


def _tiny(**kw):
    return train.tiny_lm_config(d_model=64, layers=2, vocab=256, **kw)


def _train(layout="flat", agents=4, **kw):
    axes = shd.MeshAxes(("data",), "model", {"data": agents, "model": 1})
    fed = kw.pop("fed", FedConfig(n_agents=agents, h=2, k=2,
                                  gossip_impl="pallas"))
    return steps.build_train_lowerable(
        _tiny(), ShapeConfig("t", 16, 2 * agents, "train"), axes, fed=fed,
        state_layout=layout, mesh=axes, **kw)


LOWERABLES = {
    "tree": lambda: _train("tree"),
    "flat-updmix-momentum": lambda: _train(fuse_update_mix=True,
                                           optimizer="momentum"),
    "flat-fused2-int8": lambda: _train(
        fused_steps=2, fed=FedConfig(n_agents=4, h=2, k=2,
                                     gossip_impl="sparse",
                                     gossip_compress="int8")),
    "sweep2-h": lambda: _train(fused_steps=2, sweep_runs=2, sweep_axis="h"),
    "tree-adamw-micro2": lambda: _train("tree", optimizer="adamw",
                                        microbatches=2),
    "prefill-pallas": lambda: steps.build_prefill_lowerable(
        get_config("recurrentgemma-9b").smoke(),
        ShapeConfig("p", 64, 4, "prefill"),
        shd.MeshAxes(("data",), "model", {"data": 2, "model": 1}),
        impl="pallas"),
    "decode-long": lambda: steps.build_decode_lowerable(
        get_config("gemma3-12b").smoke(), ShapeConfig("d", 300_000, 2,
                                                      "decode"),
        shd.MeshAxes(("data",), "model", {"data": 1, "model": 1})),
}


@pytest.mark.parametrize("name", list(LOWERABLES))
def test_traced_outputs_are_shaped_as_a_cpu_run(name):
    low = LOWERABLES[name]()
    lowered = low.lower()
    out = low.make_fn(torch.device("cpu"))(*low.make_args("cpu", 0))
    assert _shapes(lowered.outputs) == _shapes(out)
    assert lowered.costs.ops > 0 and lowered.costs.peak_bytes > 0
    kernels = {"flat-updmix-momentum": {"update_mix": 1},
               "flat-fused2-int8": {"gossip_mix_sparse": 2},
               "sweep2-h": {"gossip_mix_batched": 2},
               "prefill-pallas": {"flash_attention": 1, "rglru_scan": 2},
               "tree": {"gossip_mix": 12},
               "tree-adamw-micro2": {"gossip_mix": 12}}
    assert lowered.costs.launches == kernels.get(name, {})


def test_sharded_layout_traces_rank_zero_of_a_fake_world():
    import torch.distributed as dist
    for impl, kind in (("dense", "reduce-scatter"),
                       ("sparse", "collective-permute")):
        low = _train("sharded", agents=8, fed=FedConfig(
            n_agents=8, h=1, k=2, gossip_impl=impl))
        lowered = low.lower()
        assert not dist.is_initialized()
        assert low.world == 8
        costs = lowered.costs
        assert costs.collective_counts[kind] >= 1
        # the loss and the server (H = 1) sum over the ranks
        assert costs.collective_counts["all-reduce"] == 2
        assert lowered.outputs[0].flat.shape[0] == 1
    # mesh_model > 1: the 2-D engine, rank 0 of a fake world of 16 x 16
    # ranks, its (n/16, D/16) column block; line 4's gather is the model
    # dim's only collective, the gossip's on the agents dim
    from repro_torch.launch import trace_analysis
    low = steps.build_train_lowerable(
        _tiny(), ShapeConfig("t", 16, 32, "train"), AXES16,
        state_layout="sharded", mesh=AXES16, mesh_model=16)
    lowered = low.lower()
    assert not dist.is_initialized()
    assert low.world == 256 and low.name.endswith(":sharded:m16")
    d = flat_lib.make_flat_spec(build_model(_tiny()).init_shapes()).d
    assert lowered.outputs[0].flat.shape == (1, d // 16)
    assert low.in_specs[0].flat == ("data", "model")
    assert lowered.costs.collective_counts["all-gather"] == 1
    assert trace_analysis.axis_separation(lowered.costs, 16, 16) == {
        "model": ["all-gather"], "agents": ["all-reduce", "reduce-scatter"]}


@pytest.mark.parametrize("kw", [
    dict(state_layout="grid"),
    dict(state_layout="tree", fuse_update_mix=True),
    dict(state_layout="sharded"),
    dict(state_layout="tree", fused_steps=2, sweep_runs=2),
    dict(state_layout="flat", sweep_runs=2),
    dict(state_layout="flat", fused_steps=0),
    dict(fed=FedConfig(gossip_impl="permute")),
], ids=["layout", "fuse-tree", "sharded-no-mesh", "sweep-tree",
        "sweep-unfused", "fused0", "permute-no-mesh"])
def test_argument_checks_give_the_reference_messages(kw):
    rcfg = ref_train.tiny_lm_config(64, 2, vocab=256)
    rshape = REF_SHAPES["train_4k"]
    rkw = dict(kw)
    if "fed" in rkw:
        from repro.configs.base import FedConfig as RefFed
        rkw["fed"] = RefFed(gossip_impl=kw["fed"].gossip_impl)
    with pytest.raises(ValueError) as want:
        ref_steps.build_train_lowerable(rcfg, rshape, REF_AXES16, **rkw)
    with pytest.raises(ValueError) as got:
        steps.build_train_lowerable(_tiny(), SHAPES["train_4k"], AXES16,
                                    **kw)
    assert str(got.value) == str(want.value)


def _ref_spec_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(getattr(k, "key", getattr(k, "name",
                                                getattr(k, "idx", k))))
                  for k in path): tuple(v) for path, v in flat}


def _spec_leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, prefix + (str(k),)))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_spec_leaves(getattr(tree, f.name),
                                    prefix + (f.name,)))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-v3-671b",
                                  "mamba2-2.7b"])
def test_lowerable_specs_equal_the_reference(arch, shape):
    """The arguments' partition specs of each lowerable (tree training,
    prefill, decode) equal the reference's, leaf by leaf."""
    want = ref_steps.build_lowerable(ref_config(arch), REF_SHAPES[shape],
                                     REF_AXES16)
    got = steps.build_lowerable(get_config(arch), SHAPES[shape], AXES16)
    want_leaves = {}
    for i, part in enumerate(want.in_specs):
        want_leaves.update({(str(i),) + k: v
                            for k, v in _ref_spec_leaves(part).items()})
    got_leaves = {}
    for i, part in enumerate(got.in_specs):
        got_leaves.update(_spec_leaves(part, (str(i),)))
    assert want_leaves
    for path, spec in got_leaves.items():
        if path not in want_leaves:
            assert spec == (), path      # the reference's empty () trees
        else:
            assert spec == want_leaves[path], path
    assert set(want_leaves) <= set(got_leaves)


# ---------------------------------------------------------------------------
# dryrun.py
# ---------------------------------------------------------------------------


def _ref_model_flops():
    """The reference's ``_model_flops``, from its source."""
    src = Path(ref_steps.__file__).with_name("dryrun.py")
    tree = ast.parse(src.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_model_flops")
    ns: dict = {}
    exec(compile(ast.Module([fn], []), str(src), "exec"), ns)
    return ns["_model_flops"]


def test_model_flops_equal_the_reference():
    ref = _ref_model_flops()
    for arch in REF_ARCHS:
        for shape in SHAPES:
            assert dryrun._model_flops(get_config(arch), SHAPES[shape]) == \
                ref(ref_config(arch), REF_SHAPES[shape])


def test_run_one_writes_a_record(tmp_path, monkeypatch):
    """The tiny LM's train and prefill records at cut shapes: the
    reference's keys mapped to the tally's, ``status: ok``, ``fits``, and
    the roofline at the card's figures."""
    for name, shape, kw in (
            ("train_4k", ShapeConfig("train_4k", 32, 16, "train"),
             dict(state_layout="flat", fuse_update_mix=True)),
            ("prefill_32k", ShapeConfig("prefill_32k", 128, 32, "prefill"),
             dict(impl="pallas"))):
        monkeypatch.setitem(dryrun.SHAPES, name, shape)
        rec = dryrun.run_one("tiny", name, False, str(tmp_path), **kw)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["launches"] == ({"update_mix": 1} if name == "train_4k"
                                   else {"flash_attention": 12})
        path = next(tmp_path.glob(f"tiny__{name}__single*.json"))
        assert json.loads(path.read_text())["status"] == "ok"
        for key in ("arch", "shape", "mesh", "chips", "fused_steps",
                    "state_layout", "trace_s", "memory", "ops", "roofline",
                    "fits", "launches", "specs", "mesh_devices"):
            assert key in rec, key
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "alias_bytes", "temp_bytes",
                                      "peak_bytes"}
        assert set(rec["ops"]) == {
            "flops_per_device", "traffic_bytes_per_device",
            "collective_bytes", "collective_counts",
            "collective_bytes_by_kind", "op_count"}
        row = rec["roofline"]
        assert row["memory_s"] == row["hlo_bytes"] / 3.35e12
        assert rec["fits"] == (rec["memory"]["peak_bytes"] <= 80e9)
    assert rec["batch_per_card"] == 2          # 32 requests over 16 cards
    # the 2-D sharded record (at the cut train shape): traced, with its
    # collectives by axis beside the mesh2d byte model
    dryrun.main(["--arch", "tiny", "--shape", "train_4k",
                 "--state-layout", "sharded", "--mesh-agents", "16",
                 "--mesh-model", "16", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "tiny__train_4k__single__sharded__m16"
                      ".json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256
    assert rec["axis_separation"] == {
        "model": ["all-gather"], "agents": ["all-reduce", "reduce-scatter"]}
    assert rec["gossip_cost_model"]["mesh2d"]["n_model_shards"] == 16


def test_profile_one_prints_the_hot_ops(capsys):
    """launch/profile.py on the tiny LM's decode step: the peak, the
    roofline at the card's figures (the model FLOPs of one card's 8 of
    the 128 requests) and the top ops by traffic."""
    from repro_torch.launch import profile
    rep, costs, mem = profile.profile_one("tiny", "decode_32k", top=3)
    out = capsys.readouterr().out
    assert "peak memory/card:" in out and "-- top traffic ops" in out
    assert rep.useful_flops_ratio == pytest.approx(
        dryrun._model_flops(get_config("tiny"), dataclasses.replace(
            SHAPES["decode_32k"], global_batch=8)) / costs.flops)
    assert mem["peak_bytes"] == costs.peak_bytes > 0
