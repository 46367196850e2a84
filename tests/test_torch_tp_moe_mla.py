"""Tensor-parallel MoE (expert parallelism) and MLA for DeepSeek-V2-Lite
(models/moe.py, models/mla.py under a model group, sharding/tp.py's
``gather_whole``, ``check_family``) and the chunked prefill on a rank's
heads and sequence block (models/attention.py), against the JAX package,
whose model compute GSPMD partitions from the same ``param_pspecs``
placements.

One spawned gloo world of 4 ranks (started once for the module by a
fixture, while this process computes the reference's results and the
port's one-device twins) builds the meshes (1, 2) (two replicas, each a
(1, 2) slice of a 3-D mesh), (2, 2) and (1, 4) in turn and runs:

* at M = 2 and M = 4 (A = 1), against the reference's single-device
  functions: the MLA prefill on the rank's heads and the MoE layer on the
  rank's experts (DeepSeek-V2-Lite's smoke widths: 4 heads, 4 experts of
  which 2 are routed a token, one shared expert) at S = 1,024 (the MLA's
  chunks of 512 on the local heads); the tiny LM's attention in layouts
  (a) (heads 4 / KV 2 at M = 2) and (c) (heads 3 / KV 3 at M = 2 and 4:
  the sequence split, each rank's chunks at its true offsets) at S =
  1,024; DeepSeek-V2-Lite's smoke config at 3 layers (its dense first
  layer, then two MoE groups) as a model: logits, the vocabulary-parallel
  loss and every gradient (each rank's blocks put together), with remat
  on and off (equal bit for bit: the recompute reruns the collectives);
* the tree round (n 4, ring k 1, Metropolis with link failures p 0.1,
  H 2, K 2, 2 steps, batch 1 × 16 tokens) of that model at (1, 2), (2, 2)
  and (1, 4) with the gossip impls in turn, against the port's own
  one-device tree round (which tests/test_torch_train.py and
  test_torch_zoo.py hold to the reference) on the same draws, and each
  rank's state: exactly Σ over leaves of (n/A)·numel/M_leaf f32
  elements.

In this process: ``check_family`` passing DeepSeek-V2-Lite and still
refusing Queue A items 6.4–6.5, the MoE layer refusing experts that are
not this rank's E/M block, and the dry run's tree train record of
DeepSeek-V2-Lite on the partitioned world.

Tolerances: layers within 1e-5·max|y|, logits 1e-4·max|logit|, losses
1e-5 relative, gradients 1e-5·max|g|, the rounds' end states
1e-5·max|x| (TOL).  The spawned ranks import this module: its module
level imports no jax.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import types

import numpy as np
import pytest
import torch

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import feddec, sharded
from repro_torch.core.draws import Draws
from repro_torch.launch import steps
from repro_torch.launch.train import tiny_lm_config
from repro_torch.models import attention, build_model, mla, moe
from repro_torch.sharding import tp
from repro_torch.tree import leaves, tree_map
import _torch_tp_common as tpc
from _torch_tp_common import (
    B, IMPLS, LOGIT_TOL, LR, MESHES, N, S, T, TOL, WORLD, TableDraws)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S_LONG = 1024
ARCH = "deepseek-v2-lite-16b"
# attention layouts at S_LONG: (heads, KV) and the Ms it runs at
ATTN_CASES = {"heads4-kv2": ((4, 2), (2,)), "heads3-kv3": ((3, 3), (2, 4))}


def _ds_cfg(side: str = "port"):
    """DeepSeek-V2-Lite's smoke config at 3 layers: a dense prefix layer
    and two scanned MoE groups."""
    if side == "port":
        zoo = get_config
    else:
        from repro.configs import get_config as zoo
    return dataclasses.replace(zoo(ARCH).smoke(), num_layers=3)


def _attn_cfg(name: str, side: str = "port"):
    if side == "port":
        tiny = tiny_lm_config
    else:
        from repro.launch.train import tiny_lm_config as tiny
    (h, kv), _ = ATTN_CASES[name]
    return dataclasses.replace(tiny(d_model=128, layers=1, vocab=256),
                               name=name, num_heads=h, num_kv_heads=kv,
                               head_dim=16)


def _pos(b: int, s: int) -> np.ndarray:
    return np.broadcast_to(np.arange(s), (b, s)).copy()


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


def _run_layers(inp: dict, mesh) -> dict:
    """The layers and the model on this rank's blocks, made whole."""
    g = tp.ModelGroup.of(mesh)
    m = g.size
    cfg = steps.adapt_for_mesh(_ds_cfg(), tpc.axes(1, m))
    out = {}
    x = torch.from_numpy(inp["x_long"])
    pos = torch.from_numpy(_pos(*inp["x_long"].shape[:2]))
    p = tpc.blocks({"attn": tpc.to_torch(inp["mla"])}, cfg, mesh)["attn"]
    out["mla"], _ = mla.mla_attention(
        p, x, pos, cfg=cfg.mla, compute_dtype=torch.float32, tp=g,
        num_heads=cfg.num_heads)
    p = tpc.blocks({"moe": tpc.to_torch(inp["moe"])}, cfg, mesh)["moe"]
    y, aux = moe.moe_layer(p, x, cfg.moe, compute_dtype=torch.float32, tp=g)
    out["moe"], out["moe-aux"] = y, aux
    for name, (_, ms) in ATTN_CASES.items():
        if m not in ms:
            continue
        acfg = steps.adapt_for_mesh(_attn_cfg(name), tpc.axes(1, m))
        p = tpc.blocks({"attn": tpc.to_torch(inp["attn"][name])}, acfg,
                       mesh)["attn"]
        out[f"attn-{name}"], _ = attention.attention(
            p, torch.from_numpy(inp["x_attn"]),
            torch.from_numpy(_pos(*inp["x_attn"].shape[:2])),
            head_dim=acfg.head_dim, tp=g, num_heads=acfg.num_heads,
            num_kv_heads=acfg.num_kv_heads,
            weight_gather=acfg.attn_weight_gather)
    model = build_model(cfg)
    whole = tpc.to_torch(inp["params"])
    params = tpc.blocks(whole, cfg, mesh)
    batch = tpc.to_torch(inp["batch"])
    with tp.model_group(mesh):
        out["logits"] = tp._gather(model.logits(params, batch), g, 2)
        for remat in (True, False):
            loss, grads = model.grad_fn(remat=remat)(params, batch)
            out[f"loss-{remat}"] = loss
            out[f"grads-{remat}"] = tpc.whole(grads, whole, cfg, mesh)
    return tpc.to_numpy(out)


def _run_tp_round(mesh, impl, start, batches, draws):
    """This rank's tensor-parallel tree round: the gathered end state,
    the losses and this rank's bytes."""
    a = mesh.get_local_rank("agents")
    n_local = N // int(mesh.mesh.shape[0])
    tcfg = steps.adapt_for_mesh(_ds_cfg(), tp.mesh_axes(mesh))
    state = tpc.start_state(start)
    specs = shd.param_pspecs(tcfg, state.params, tp.mesh_axes(mesh))
    blk = sharded.shard_tree_state(state, specs, mesh)
    rnd = sharded.make_sharded_tree_round(
        tpc.round_setup(impl), build_model(tcfg).grad_fn(), lambda t: LR, mesh,
        device="cpu", param_specs=specs)
    rows = slice(a * n_local, (a + 1) * n_local)
    blk, met = rnd(blk, {k: torch.from_numpy(v[:, rows])
                         for k, v in batches.items()}, draws)
    ts = [t for t in leaves(blk.params) if t.ndim > 1]
    nbytes = (sum(t.numel() * t.element_size() for t in ts),
              sum(t.untyped_storage().nbytes() for t in ts))
    whole = sharded.gather_tree_state(blk, specs, mesh)
    return {"params": tpc.to_numpy(whole.params),
            "losses": met["loss"].tolist(),
            "bytes": nbytes}


def _run_twin(impl, start, batches, draws):
    """The port's one-device tree round."""
    rnd = feddec.make_feddec_round(tpc.round_setup(impl),
                                   build_model(_ds_cfg()).grad_fn(),
                                   lambda t: LR, device="cpu")
    state, met = rnd(tpc.start_state(start), tpc.to_torch(batches), draws)
    return {"params": tpc.to_numpy(state.params),
            "losses": met["loss"].tolist()}


def _world_main(rank, world, store_path, inputs_path, out_path):
    """One rank of the spawned gloo world; rank 0 writes what every rank
    reported."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        inp = tpc.wait_for(inputs_path)
        mine = {}
        for i, (a, m) in enumerate(MESHES):
            mesh = tpc.fed_mesh(a, m)
            if a == 1 and rank < a * m:
                mine[("layers", m)] = _run_layers(inp, mesh)
            mine[("round", a, m)] = _run_tp_round(
                mesh, IMPLS[i], inp["start"], inp["batches"],
                TableDraws(inp["tables"]))
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side and the inputs (this process)
# ---------------------------------------------------------------------------


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    cfg = _ds_cfg()
    d = cfg.d_model
    params = build_model(cfg).init(Draws(5, "cpu"))
    block = params["stack"]["scan"]["sub_0"]
    perturb = lambda p: (p.numpy() + 0.01 * rng.standard_normal(  # noqa
        p.shape)).astype(np.float32)
    inp = {"params": tree_map(perturb, params),
           "mla": tree_map(lambda p: perturb(p[0]), block["attn"]),
           "moe": tree_map(lambda p: perturb(p[0]), block["moe"]),
           "x_long": rng.standard_normal((1, S_LONG, d)).astype(np.float32),
           "x_attn": rng.standard_normal((1, S_LONG, 128)).astype(
               np.float32),
           "batch": {"tokens": rng.integers(0, cfg.vocab_size, (2, S)),
                     "positions": _pos(2, S)},
           "attn": {}, "tables": tpc.tables()}
    for name, ((h, kv), _) in ATTN_CASES.items():
        inp["attn"][name] = {
            "wq": {"w": (rng.standard_normal((128, h, 16)) / 128 ** 0.5
                         ).astype(np.float32)},
            "wk": {"w": (rng.standard_normal((128, kv, 16)) / 128 ** 0.5
                         ).astype(np.float32)},
            "wv": {"w": (rng.standard_normal((128, kv, 16)) / 128 ** 0.5
                         ).astype(np.float32)},
            "wo": {"w": (rng.standard_normal((h, 16, 128)) / (h * 16) ** 0.5
                         ).astype(np.float32)}}
    start = build_model(cfg).init(Draws(3, "cpu"))
    inp["start"] = tree_map(lambda p: (p.numpy()[None] + 0.01 * rng.normal(
        size=(N,) + tuple(p.shape))).astype(np.float32), start)
    inp["batches"] = {"tokens": rng.integers(0, cfg.vocab_size,
                                             (T, N, B, S)),
                      "positions": np.broadcast_to(np.arange(S),
                                                   (T, N, B, S)).copy()}
    return inp


def _reference(inp: dict) -> dict:
    """The reference's single-device layers and model."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ref_attn
    from repro.models import build_model as ref_build_model
    from repro.models import mla as ref_mla
    from repro.models import moe as ref_moe
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    cfg = _ds_cfg("ref")
    x = jnp.asarray(inp["x_long"])
    pos = jnp.asarray(_pos(*inp["x_long"].shape[:2]))
    out = {"mla": ref_mla.mla_attention(
        j(inp["mla"]), x, pos, num_heads=cfg.num_heads, cfg=cfg.mla,
        compute_dtype=jnp.float32)[0]}
    out["moe"], out["moe-aux"] = ref_moe.moe_layer(
        j(inp["moe"]), x, cfg.moe, compute_dtype=jnp.float32)
    for name in ATTN_CASES:
        acfg = _attn_cfg(name, "ref")
        out[f"attn-{name}"], _ = ref_attn.attention(
            j(inp["attn"][name]), jnp.asarray(inp["x_attn"]),
            jnp.asarray(_pos(*inp["x_attn"].shape[:2])),
            num_kv_heads=acfg.num_kv_heads, head_dim=acfg.head_dim,
            compute_dtype=jnp.float32)
    model = ref_build_model(cfg)
    params, batch = j(inp["params"]), {
        k: jnp.asarray(v, jnp.int32) for k, v in inp["batch"].items()}
    out["logits"] = model.logits(params, batch)[0]
    out["loss"], out["grads"] = jax.jit(model.grad_fn())(
        params, batch, jax.random.key(0))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's report and this process's reference results and
    one-device twins: the world runs while this process computes them."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp_moe")
    inputs, out_path = tmp / "inputs.pkl", tmp / "out.pkl"
    ctx = mp.start_processes(
        _world_main, args=(WORLD, str(tmp / "store"), str(inputs),
                           str(out_path)),
        nprocs=WORLD, start_method="spawn", join=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = _inputs()
        with open(tmp / "inputs.tmp", "wb") as f:
            pickle.dump(inp, f)
        os.replace(tmp / "inputs.tmp", inputs)
        twins = {impl: _run_twin(impl, inp["start"], inp["batches"],
                                 TableDraws(inp["tables"]))
                 for impl in IMPLS}
    finally:
        torch.set_num_threads(threads)
    want = _reference(inp)
    while not ctx.join():
        pass
    with open(out_path, "rb") as f:
        every = pickle.load(f)
    return {"ranks": every, "want": want, "twins": twins}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("key", ["mla", "moe", "moe-aux"])
def test_tp_mla_and_moe_layers_match_reference(world, key, m):
    got = world["ranks"][0][("layers", m)][key]
    tpc.assert_close(got, world["want"][key], TOL)


ATTN_IDS = [(n, m) for n, (_, ms) in ATTN_CASES.items() for m in ms]


@pytest.mark.parametrize("name,m", ATTN_IDS,
                         ids=[f"{n}-m{m}" for n, m in ATTN_IDS])
def test_tp_attention_chunked_prefill_matches_reference(world, name, m):
    """Layouts (a) and (c) at S = 1,024: the chunks on the local heads,
    and in (c) on the rank's sequence block at its true offsets."""
    cfg = steps.adapt_for_mesh(_attn_cfg(name), tpc.axes(1, m))
    assert cfg.attn_weight_gather == (name == "heads3-kv3")
    got = world["ranks"][0][("layers", m)][f"attn-{name}"]
    tpc.assert_close(got, world["want"][f"attn-{name}"], TOL)


@pytest.mark.parametrize("m", [2, 4])
def test_tp_deepseek_logits_loss_and_grads_match_reference(world, m):
    """DeepSeek-V2-Lite's smoke model on the blocks: logits (put
    together over the vocabulary) 1e-4·max|logit|, the loss 1e-5, every
    gradient 1e-5·max|g|, the same loss on every rank of the group."""
    out = world["ranks"][0][("layers", m)]
    want = world["want"]
    tpc.assert_close(out["logits"], want["logits"], LOGIT_TOL)
    np.testing.assert_allclose(out["loss-True"], want["loss"], rtol=TOL)
    tpc.assert_close(out["grads-True"], want["grads"], TOL)
    for rank in world["ranks"][1:m]:
        assert rank[("layers", m)]["loss-True"] == out["loss-True"]


@pytest.mark.parametrize("m", [2, 4])
def test_tp_remat_on_and_off_are_equal_bit_for_bit(world, m):
    out = world["ranks"][0][("layers", m)]
    assert out["loss-True"] == out["loss-False"]
    np.testing.assert_array_equal(tpc.flat(out["grads-True"]),
                                  tpc.flat(out["grads-False"]))


@pytest.mark.parametrize("a,m", MESHES, ids=[f"{a}x{m}" for a, m in MESHES])
def test_tp_tree_round_matches_one_device_twin(world, a, m):
    impl = IMPLS[MESHES.index((a, m))]
    want = world["twins"][impl]
    got = world["ranks"][0][("round", a, m)]
    tpc.assert_close(got["params"], want["params"], TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for rep in world["ranks"][1:]:
        assert rep[("round", a, m)]["losses"] == got["losses"]


@pytest.mark.parametrize("a,m", MESHES, ids=[f"{a}x{m}" for a, m in MESHES])
def test_each_rank_holds_exactly_its_moe_and_mla_blocks(world, a, m):
    cfg = _ds_cfg()
    shapes = feddec.init_state(build_model(cfg).init_shapes(), N).params
    mesh = types.SimpleNamespace(mesh_dim_names=("agents", "model"),
                                 mesh=np.zeros((a, m)))
    axes = tp.mesh_axes(mesh)
    specs = shd.param_pspecs(cfg, shapes, axes)
    want = 4 * sum(tp.block_numel(tuple(s.shape), sp, axes.sizes)
                   for s, sp in zip(leaves(shapes), leaves(specs))
                   if len(s.shape) > 1)
    moe_specs = specs["stack"]["scan"]["sub_0"]["moe"]
    assert moe_specs["wi"]["w"] == ("agents", None, "model", None, None)
    assert moe_specs["router"]["w"] == ("agents", None, None, "model")
    assert specs["stack"]["scan"]["sub_0"]["attn"]["wkv_a"]["w"] == \
        ("agents", None, None, None)
    for rep in world["ranks"]:
        elems, storage = rep[("round", a, m)]["bytes"]
        assert elems == storage == want


# ---------------------------------------------------------------------------
# in this process: the refusals and the dry-run record
# ---------------------------------------------------------------------------


def test_check_family_passes_deepseek_v2_lite():
    tp.check_family(get_config(ARCH))
    tp.check_family(get_config(ARCH).smoke())


@pytest.mark.parametrize("arch,item", [
    ("mistral-large-123b", "6.4"), ("deepseek-v3-671b", "6.4")])
def test_check_family_still_refuses_the_later_slices(arch, item):
    with pytest.raises(NotImplementedError,
                       match=rf"Queue A item {item}\b"):
        tp.check_family(get_config(arch))


@pytest.fixture
def fake_group():
    """An ambient model group of 2 ranks that no collective reaches."""
    tp._ACTIVE["model"] = tp.ModelGroup(None, 0, 2)
    yield
    tp._ACTIVE.pop("model", None)


def test_tp_decode_still_refuses(fake_group):
    """A decode step under a model group is Queue A item 6.5, for MLA's
    absorbed decode too."""
    cfg = dataclasses.replace(_ds_cfg(), tp_axis_name="model")
    model = build_model(cfg)
    params = model.init_shapes()
    caches = model.init_caches(1, 8, device="meta")
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.long, device="meta"),
             "positions": torch.zeros((1, 1), dtype=torch.long,
                                      device="meta")}
    with pytest.raises(NotImplementedError, match=r"Queue A item 6\.5"):
        model.decode_step(params, batch, caches)
    with pytest.raises(NotImplementedError, match=r"Queue A item 6\.5"):
        mla.mla_attention(params["stack"]["pre_0"]["attn"],
                          torch.zeros((1, 1, cfg.d_model), device="meta"),
                          batch["positions"], cfg=cfg.mla,
                          cache=caches["pre_0"]["self"],
                          tp=tp._ACTIVE["model"], num_heads=cfg.num_heads)


@pytest.mark.parametrize("num_experts,e_local", [(4, 4), (5, 2), (5, 5)])
def test_tp_moe_refuses_a_block_that_is_not_its_experts(fake_group,
                                                        num_experts, e_local):
    """Under a model group of 2 the MoE layer takes only this rank's
    E/M experts: a whole (E, d, f) tree, or E that 2 does not divide, is
    refused, never run whole on each rank."""
    cfg = dataclasses.replace(_ds_cfg().moe, num_experts=num_experts)
    d, f = 8, 4
    z = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    p = {"router": {"w": z(d, e_local)}, "wi": {"w": z(e_local, d, f)},
         "wg": {"w": z(e_local, d, f)}, "wo": {"w": z(e_local, f, d)}}
    with pytest.raises(NotImplementedError, match="expert-parallel MoE"):
        moe.moe_layer(p, z(1, 4, d), cfg, compute_dtype=torch.float32,
                      tp=tp._ACTIVE["model"])


def test_dryrun_deepseek_tree_record_is_the_partitioned_world(tmp_path,
                                                              monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 16, 32, "train"))
    # the smoke widths with 16 heads and 16 experts, which the 16 model
    # ranks divide
    cfg = _ds_cfg()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dataclasses.replace(
        cfg, num_heads=16, num_kv_heads=16,
        moe=dataclasses.replace(cfg.moe, num_experts=16)))
    rec = dryrun.run_one(ARCH, "train_4k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["tensor_parallel"] is True
