"""Tensor-parallel Mamba2 and RecurrentGemma (models/ssm.py's SSD mixer on
the rank's heads, models/griffin.py's RG-LRU block on its width,
models/layers.py's gated norm over a partitioned width and the table and
head cut on d, sharding/tp.py's ``local_parts`` and ``check_family``),
against the JAX package, whose model compute GSPMD partitions from the
same ``param_pspecs`` placements.

One spawned gloo world of 4 ranks (started once for the module by a
fixture, while this process computes the reference's results and the
port's one-device twins) builds the meshes (1, 2) (two replicas, each a
(1, 2) slice of a 3-D mesh), (2, 2) and (1, 4) in turn and runs:

* at M = 2 and M = 4 (A = 1), against the reference's single-device
  functions at the smoke widths (d 256; Mamba2: 16 heads of 32, state
  16; RG-LRU width 256), on x (2, 32, 256): the Mamba2 mixer and the
  RG-LRU block, each with ``use_pallas`` off and on (on the CPU the
  kernel wrappers take their plain versions); the RMS norm over a width
  cut on the group, forward and gradients, against a whole-width norm;
  three models (Mamba2's smoke config, RecurrentGemma's at 6 layers, two
  scanned groups of its (rglru, rglru, attn) pattern, and Mamba2's at a
  vocabulary of 511, which the group does not divide: its table and head
  cut on d): logits under impl 'xla' and 'pallas', loss and every
  gradient (each rank's blocks put together), with remat on and off
  (equal bit for bit); the kernel wrappers refuse a strided input there,
  as they do on the card;
* the tree round (n 4, ring k 1, Metropolis with link failures p 0.1,
  H 2, K 2, 2 steps, batch 1 × 16 tokens) of Mamba2's and
  RecurrentGemma's smoke models at (1, 2), (2, 2) and (1, 4) under
  'dense', 'pallas' and 'sparse' in turn, against the port's own
  one-device tree round (which tests/test_torch_train_zoo.py holds to the
  reference) on the same draws, and each rank's state: exactly Σ over
  leaves of (n/A)·numel/M_leaf f32 elements.

In this process: ``check_family`` passing both models, their logits and
train step traced on a fake 2 × 2 world, and the dry run's tree train
records of both on the partitioned world.

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
from repro_torch.models import build_model, griffin, layers, ssm
from repro_torch.sharding import tp
from repro_torch.tree import leaves, tree_map
import _torch_tp_common as tpc
from _torch_tp_common import (
    B, IMPLS, LOGIT_TOL, LR, MESHES, N, S, T, TOL, WORLD, TableDraws)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

X_SHAPE = (2, 32, 256)
NORM_SHAPE = (2, 8, 64)
MAMBA, RG = "mamba2-2.7b", "recurrentgemma-9b"
# model case -> (arch, layers or None for the smoke depth, vocabulary or
# None for the smoke one)
MODELS = {"mamba2": (MAMBA, None, None), "rg": (RG, 6, None),
          "mamba2-v511": (MAMBA, None, 511)}
ROUND_MODELS = ("mamba2", "rg")


def _cfg(case: str, side: str = "port"):
    if side == "port":
        zoo = get_config
    else:
        from repro.configs import get_config as zoo
    arch, n_layers, vocab = MODELS[case]
    cfg = zoo(arch).smoke()
    if n_layers:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg


def _pos(b: int, s: int) -> np.ndarray:
    return np.broadcast_to(np.arange(s), (b, s)).copy()


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


def _run_norm(inp: dict, g) -> dict:
    """The RMS norm over a width cut on the group: this rank's block of
    y and of x's gradient, and the scale's gradient (whole), of the sum
    of y·r over the ranks."""
    x, r = (torch.from_numpy(inp[k]) for k in ("norm_x", "norm_r"))
    width = x.shape[-1]
    blk = width // g.size
    cut = slice(g.rank * blk, (g.rank + 1) * blk)
    xb = x[..., cut].clone().requires_grad_()
    scale = torch.from_numpy(inp["norm_scale"]).requires_grad_()
    y = layers.rms_norm({"scale": scale}, xb, tp=g, width=width)
    gx, gs = torch.autograd.grad((y * r[..., cut]).sum(), (xb, scale))
    return {"y": tp._gather(y.detach(), g, -1),
            "gx": tp._gather(gx, g, -1), "gs": gs}


class _DenseKernelInputs:
    """The kernel wrappers #15-#17 made to refuse a strided tensor, as
    they do on the card (on the CPU they take their plain versions, which
    take any strides)."""

    NAMES = ("ssd_scan", "rglru_scan", "flash_attention")

    def __enter__(self):
        from repro_torch.kernels import ops
        self.saved = {n: getattr(ops, n) for n in self.NAMES}

        def dense_only(fn):
            def call(*args, **kw):
                for t in args:
                    if isinstance(t, torch.Tensor):
                        assert t.is_contiguous(), (fn.__name__, t.stride())
                return fn(*args, **kw)
            return call

        for n, fn in self.saved.items():
            setattr(ops, n, dense_only(fn))

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self.saved.items():
            setattr(ops, n, fn)


def _run_layers(inp: dict, mesh) -> dict:
    """The blocks, the norm and the models on this rank's blocks, made
    whole."""
    g = tp.ModelGroup.of(mesh)
    m = g.size
    out = {"norm": _run_norm(inp, g)}
    x = torch.from_numpy(inp["x"])
    mcfg = steps.adapt_for_mesh(_cfg("mamba2"), tpc.axes(1, m))
    rcfg = steps.adapt_for_mesh(_cfg("rg"), tpc.axes(1, m))
    pm = tpc.blocks({"mixer": tpc.to_torch(inp["mamba"])}, mcfg, mesh)["mixer"]
    pr = tpc.blocks({"mixer": tpc.to_torch(inp["rglru"])}, rcfg, mesh)["mixer"]
    for pallas in (False, True):
        with _DenseKernelInputs():
            out[f"mamba-{pallas}"], _ = ssm.mamba2_block(
                pm, x, mcfg.ssm, compute_dtype=torch.float32,
                use_pallas=pallas, tp=g)
            out[f"rglru-{pallas}"], _ = griffin.rglru_block(
                pr, x, compute_dtype=torch.float32, use_pallas=pallas,
                tp=g, width=rcfg.d_ff_rglru)
    for case in MODELS:
        cfg = steps.adapt_for_mesh(_cfg(case), tpc.axes(1, m))
        model = build_model(cfg)
        whole = tpc.to_torch(inp["params"][case])
        params = tpc.blocks(whole, cfg, mesh)
        batch = tpc.to_torch(inp["batch"][case])
        with tp.model_group(mesh):
            for impl in ("xla", "pallas"):
                with _DenseKernelInputs():
                    lg = model.logits(params, batch, impl=impl)
                if lg.shape[-1] != cfg.vocab_size:
                    lg = tp._gather(lg, g, 2)
                out[f"{case}-logits-{impl}"] = lg
            for remat in (True, False):
                loss, grads = model.grad_fn(remat=remat)(params, batch)
                out[f"{case}-loss-{remat}"] = loss
                out[f"{case}-grads-{remat}"] = tpc.whole(grads, whole, cfg,
                                                      mesh)
    return tpc.to_numpy(out)


def _run_tp_round(mesh, case, impl, start, batches, draws):
    """This rank's tensor-parallel tree round: the gathered end state,
    the losses and this rank's bytes."""
    a = mesh.get_local_rank("agents")
    n_local = N // int(mesh.mesh.shape[0])
    tcfg = steps.adapt_for_mesh(_cfg(case), tp.mesh_axes(mesh))
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


def _run_twin(case, impl, start, batches, draws):
    """The port's one-device tree round."""
    rnd = feddec.make_feddec_round(tpc.round_setup(impl),
                                   build_model(_cfg(case)).grad_fn(),
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
            for case in ROUND_MODELS:
                mine[("round", case, a, m)] = _run_tp_round(
                    mesh, case, IMPLS[i], inp["start"][case],
                    inp["batches"][case], TableDraws(inp["tables"]))
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

    def perturb(p):
        return (p.numpy() + 0.01 * rng.standard_normal(p.shape)).astype(
            np.float32)

    inp = {"params": {}, "batch": {}, "start": {}, "batches": {},
           "tables": tpc.tables(),
           "x": rng.standard_normal(X_SHAPE).astype(np.float32),
           "norm_x": rng.standard_normal(NORM_SHAPE).astype(np.float32),
           "norm_r": rng.standard_normal(NORM_SHAPE).astype(np.float32),
           "norm_scale": (0.1 * rng.standard_normal(NORM_SHAPE[-1:])
                          ).astype(np.float32)}
    for case in MODELS:
        cfg = _cfg(case)
        params = build_model(cfg).init(Draws(5, "cpu"))
        inp["params"][case] = tree_map(perturb, params)
        inp["batch"][case] = {
            "tokens": rng.integers(0, cfg.vocab_size, (2, 2 * S)),
            "positions": _pos(2, 2 * S)}
    inp["mamba"] = inp["params"]["mamba2"]["stack"]["scan"]["sub_0"][
        "mixer"]
    inp["mamba"] = tree_map(lambda p: p[0], inp["mamba"])
    inp["rglru"] = tree_map(lambda p: p[0], inp["params"]["rg"]["stack"][
        "scan"]["sub_0"]["mixer"])
    for case in ROUND_MODELS:
        cfg = _cfg(case)
        start = build_model(cfg).init(Draws(3, "cpu"))
        inp["start"][case] = tree_map(lambda p: (
            p.numpy()[None] + 0.01 * rng.normal(size=(N,) + tuple(p.shape))
        ).astype(np.float32), start)
        inp["batches"][case] = {
            "tokens": rng.integers(0, cfg.vocab_size, (T, N, B, S)),
            "positions": np.broadcast_to(np.arange(S), (T, N, B, S)).copy()}
    return inp


def _reference(inp: dict) -> dict:
    """The reference's single-device layers and models."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as ref_build_model
    from repro.models import griffin as ref_griffin
    from repro.models import layers as ref_layers
    from repro.models import ssm as ref_ssm
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    x = jnp.asarray(inp["x"])
    out = {"mamba": ref_ssm.mamba2_block(
        j(inp["mamba"]), x, _cfg("mamba2", "ref").ssm,
        compute_dtype=jnp.float32)[0],
        "rglru": ref_griffin.rglru_block(j(inp["rglru"]), x,
                                         compute_dtype=jnp.float32)[0]}

    def norm_loss(xn, scale):
        y = ref_layers.rms_norm({"scale": scale}, xn)
        return jnp.sum(y * inp["norm_r"]), y

    (_, y), (gx, gs) = jax.value_and_grad(norm_loss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(inp["norm_x"]), jnp.asarray(inp["norm_scale"]))
    out["norm"] = {"y": y, "gx": gx, "gs": gs}
    for case in MODELS:
        model = ref_build_model(_cfg(case, "ref"))
        params, batch = j(inp["params"][case]), {
            k: jnp.asarray(v, jnp.int32)
            for k, v in inp["batch"][case].items()}
        out[f"{case}-logits"] = model.logits(params, batch)[0]
        out[f"{case}-loss"], out[f"{case}-grads"] = jax.jit(
            model.grad_fn())(params, batch, jax.random.key(0))
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's report and this process's reference results and
    one-device twins: the world runs while this process computes them."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp_ssm")
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
        twins = {(case, impl): _run_twin(case, impl, inp["start"][case],
                                         inp["batches"][case],
                                         TableDraws(inp["tables"]))
                 for case in ROUND_MODELS for impl in IMPLS}
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
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("block", ["mamba", "rglru"])
def test_tp_mamba2_and_rglru_blocks_match_reference(world, block, pallas,
                                                    m):
    """The Mamba2 mixer on the rank's heads and the RG-LRU block on its
    width, 1e-5·max|y| of the reference's whole block."""
    got = world["ranks"][0][("layers", m)][f"{block}-{pallas}"]
    tpc.assert_close(got, world["want"][block], TOL)
    for rank in world["ranks"][1:m]:
        np.testing.assert_array_equal(
            rank[("layers", m)][f"{block}-{pallas}"], got)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("key", ["y", "gx", "gs"])
def test_tp_norm_over_a_cut_width_matches_a_whole_width_norm(world, key, m):
    """The gated norm's all-reduce alone: y and x's gradient (each rank's
    block put together) and the scale's (whole on every rank) within
    1e-5·max of the reference's norm over the whole width."""
    got = world["ranks"][0][("layers", m)]["norm"][key]
    tpc.assert_close(got, world["want"]["norm"][key], TOL)
    if key == "gs":
        for rank in world["ranks"][1:m]:
            np.testing.assert_array_equal(rank[("layers", m)]["norm"][key],
                                          got)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(MODELS))
def test_tp_models_logits_loss_and_grads_match_reference(world, case, m):
    """Each model on the blocks: logits under both impls (put together
    over the vocabulary where it is cut) 1e-4·max|logit|, the loss 1e-5, every
    gradient 1e-5·max|g|, the same loss on every rank of the group."""
    out = world["ranks"][0][("layers", m)]
    want = world["want"]
    for impl in ("xla", "pallas"):
        tpc.assert_close(out[f"{case}-logits-{impl}"], want[f"{case}-logits"],
                      LOGIT_TOL)
    np.testing.assert_allclose(out[f"{case}-loss-True"], want[f"{case}-loss"],
                               rtol=TOL)
    tpc.assert_close(out[f"{case}-grads-True"], want[f"{case}-grads"], TOL)
    for rank in world["ranks"][1:m]:
        assert rank[("layers", m)][f"{case}-loss-True"] == \
            out[f"{case}-loss-True"]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(MODELS))
def test_tp_remat_on_and_off_are_equal_bit_for_bit(world, case, m):
    out = world["ranks"][0][("layers", m)]
    assert out[f"{case}-loss-True"] == out[f"{case}-loss-False"]
    np.testing.assert_array_equal(tpc.flat(out[f"{case}-grads-True"]),
                                  tpc.flat(out[f"{case}-grads-False"]))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("part", ["embed", "head"])
def test_d_sharded_table_and_head_match_reference(world, part, m):
    """A vocabulary of 511, which neither group divides: the table and
    the head are cut on d (``param_pspecs``' fallback), the logits are
    whole on every rank, and the table's and head's gradients are the
    reference's within 1e-5·max|g|."""
    cfg = _cfg("mamba2-v511")
    shapes = build_model(cfg).init_shapes()
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], shapes),
                             tpc.axes(1, m))
    if part == "embed":
        assert specs["embed"]["table"] == ("agents", None, "model")
    else:
        assert specs["head"]["w"] == ("agents", "model", None)
    out = world["ranks"][0][("layers", m)]
    want = world["want"]["mamba2-v511-grads"][part]
    tpc.assert_close(out["mamba2-v511-grads-True"][part], want, TOL)
    tpc.assert_close(out["mamba2-v511-logits-xla"],
                  world["want"]["mamba2-v511-logits"], LOGIT_TOL)


ROUND_IDS = [(c, a, m) for c in ROUND_MODELS for a, m in MESHES]


@pytest.mark.parametrize("case,a,m", ROUND_IDS,
                         ids=[f"{c}-{a}x{m}" for c, a, m in ROUND_IDS])
def test_tp_tree_round_matches_one_device_twin(world, case, a, m):
    impl = IMPLS[MESHES.index((a, m))]
    want = world["twins"][(case, impl)]
    got = world["ranks"][0][("round", case, a, m)]
    tpc.assert_close(got["params"], want["params"], TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for rep in world["ranks"][1:]:
        assert rep[("round", case, a, m)]["losses"] == got["losses"]


@pytest.mark.parametrize("case,a,m", ROUND_IDS,
                         ids=[f"{c}-{a}x{m}" for c, a, m in ROUND_IDS])
def test_each_rank_holds_exactly_its_ssm_and_rglru_blocks(world, case, a,
                                                          m):
    cfg = _cfg(case)
    shapes = feddec.init_state(build_model(cfg).init_shapes(), N).params
    mesh = types.SimpleNamespace(mesh_dim_names=("agents", "model"),
                                 mesh=np.zeros((a, m)))
    axes = tp.mesh_axes(mesh)
    specs = shd.param_pspecs(cfg, shapes, axes)
    want = 4 * sum(tp.block_numel(tuple(s.shape), sp, axes.sizes)
                   for s, sp in zip(leaves(shapes), leaves(specs))
                   if len(s.shape) > 1)
    mixer = specs["stack"]["scan"]["sub_0"]["mixer"]
    if case == "mamba2":
        assert mixer["in_proj"]["w"] == ("agents", None, None, "model")
        assert mixer["conv_w"] == ("agents", None, None, "model")
        assert mixer["out_proj"]["w"] == ("agents", None, "model", None)
    else:
        assert mixer["w_a"]["w"] == ("agents", None, None, "model")
        assert mixer["w_a"]["b"] == ("agents", None, None)
    for rep in world["ranks"]:
        elems, storage = rep[("round", case, a, m)]["bytes"]
        assert elems == storage == want


# ---------------------------------------------------------------------------
# in this process: the family check, a trace on a fake world, the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_check_family_passes_mamba2_and_recurrentgemma(arch):
    tp.check_family(get_config(arch))
    tp.check_family(get_config(arch).smoke())


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_tp_logits_and_train_step_trace_on_a_2x2_world(arch):
    """Each model's logits on rank 0's blocks of a model group of 2 (a
    fake world: shapes only) are its block of the vocabulary, and
    ``build_train_lowerable`` traces its tree step on the 2 × 2 axes."""
    cfg = steps.adapt_for_mesh(get_config(arch).smoke(), tpc.axes(2, 2))
    model = build_model(cfg)
    shapes = model.init_shapes()
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], shapes),
                             tpc.axes(2, 2))
    coords = {"agents": (0, 2), "model": (0, 2)}
    params = tree_map(lambda t: t[0], tp.shard_params(
        tree_map(lambda t: t[None], shapes), specs, None, coords=coords))
    batch = {k: torch.zeros((1, 16), dtype=torch.long, device="meta")
             for k in ("tokens", "positions")}
    with steps._fake_world(2):
        tp._ACTIVE["model"] = tp.ModelGroup(None, 0, 2)
        try:
            logits = model.logits(params, batch)
        finally:
            tp._ACTIVE.pop("model", None)
    assert tuple(logits.shape) == (1, 16, cfg.vocab_size // 2)
    axes = shd.MeshAxes(("data",), "model", {"data": 2, "model": 2})
    low = steps.build_train_lowerable(get_config(arch).smoke(),
                                      ShapeConfig("t", 16, 4, "train"), axes,
                                      mesh=axes)
    assert low.world == 4
    assert low.lower().costs.collective_counts["all-reduce"] > 0


@pytest.mark.parametrize("arch", [MAMBA, RG])
def test_dryrun_tree_record_is_the_partitioned_program(arch, tmp_path,
                                                       monkeypatch):
    """The tree train record on the 16 × 16 world at the smoke widths
    (RecurrentGemma's with its 16 query heads on one KV head, Mamba2's
    with its vocabulary of 50,280, which 16 does not divide): rank 0 of
    256, the table its block."""
    from repro_torch.launch import dryrun
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 16, 32, "train"))
    cfg = get_config(arch).smoke()
    cfg = dataclasses.replace(cfg, vocab_size=50_280) if arch == MAMBA \
        else dataclasses.replace(cfg, num_heads=16)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    rec = dryrun.run_one(arch, "train_4k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["tensor_parallel"] is True
    table = rec["specs"][0]["params"]["embed"]["table"]
    assert table == (["data", None, "model"] if arch == MAMBA
                     else ["data", "model", None])
    axes = shd.MeshAxes(("data",), "model", {"data": 16, "model": 16})
    low = steps.build_train_lowerable(cfg, dryrun.SHAPES["train_4k"], axes,
                                      mesh=axes)
    block = low.lower().outputs[0].params["embed"]["table"]
    assert tuple(block.shape) == ((1, 50_280, 256 // 16) if arch == MAMBA
                                  else (1, 512 // 16, 256))


def test_tied_table_cut_on_d_is_refused():
    """RecurrentGemma's tied table at a vocabulary of 511, which the
    model group of 2 does not divide, is cut on d: its lookup runs, and
    the tied head, not ported for such a table, raises."""
    cfg = dataclasses.replace(
        steps.adapt_for_mesh(get_config(RG).smoke(), tpc.axes(1, 2)),
        vocab_size=511)
    model = build_model(cfg)
    shapes = model.init_shapes()
    specs = shd.param_pspecs(cfg, tree_map(lambda t: t[None], shapes),
                             tpc.axes(1, 2))
    assert specs["embed"]["table"] == ("agents", None, "model")
    params = tree_map(lambda t: t[0], tp.shard_params(
        tree_map(lambda t: t[None], shapes), specs, None,
        coords={"agents": (0, 1), "model": (0, 2)}))
    batch = {k: torch.zeros((1, 8), dtype=torch.long, device="meta")
             for k in ("tokens", "positions")}
    with steps._fake_world(2):
        tp._ACTIVE["model"] = tp.ModelGroup(None, 0, 2)
        try:
            with pytest.raises(NotImplementedError, match="tied table cut"):
                model.logits(params, batch)
        finally:
            tp._ACTIVE.pop("model", None)
