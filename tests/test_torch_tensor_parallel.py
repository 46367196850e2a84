"""The port's tensor-parallel model compute (sharding/tp.py, the
tensor-parallel layers of models/layers.py, attention.py, transformer.py
and model.py, the tree engine on the ('agents', 'model') mesh of
core/sharded.py, ``gossip.make_permute_gossip(leaf_specs=...)`` and
``build_train_lowerable``'s partitioned tree program) against the JAX
package, whose model compute GSPMD partitions from the same
``param_pspecs`` placements.

* One spawned gloo world of 4 ranks (started once for the module by a
  fixture, while this process and one subprocess compute the reference's
  results) builds the meshes (1, 2) (two replicas, each a (1, 2) slice of
  a 3-D mesh), (2, 2) and (1, 4) in turn and runs:

  - at M = 2 and M = 4, the layers on their blocks against the
    reference's single-device functions: the column-parallel (wi) and
    row-parallel (wo) dense layers, the four MLP kinds, the
    vocabulary-parallel embedding and unembedding, attention in the
    reference's three layouts made reachable by hand-set one-layer
    configs of the tiny LM ((a) heads 4 / KV 2 at M = 2, (b) heads 6 /
    KV 3 at M = 2, whose query heads map to their KV heads unevenly, (c)
    heads 3 / KV 3 at M = 2 and 4), and each config's logits and
    vocabulary-parallel loss;
  - the tree round (n 4, ring k 1, Metropolis with link failures p 0.1,
    H 2, K 2, 2 steps, batch 1 × 8 tokens) of the tiny LM (d 128: heads
    2 / KV 1, layout (b) at M = 2 and (c) at M = 4), Qwen1.5-4B,
    Gemma3-12B and Nemotron-4-15B at smoke width, and the (b) and (c)
    configs, at (1, 2), (2, 2) and (1, 4) with the gossip impls in turn,
    against the reference's tree round on one device under its replayed
    draws; and momentum, adamw, int8, bf16 and 'none' cells against the
    port's own one-device tree round (whose optimizers and codecs
    tests/test_torch_feddec.py holds to the reference);
  - each rank's state: exactly Σ over leaves of (n/A)·numel/M_leaf f32
    elements, each leaf its own storage;
  - at (2, 2): the partitioned training lowerable
    (``build_train_lowerable(state_layout='tree', mesh=2×2)``, Qwen1.5-4B
    smoke, 2 agents, a fused round of 2 steps, H 2), dense and 'permute',
    executed with the reference's start, batches and draws; and
    ``make_permute_gossip(leaf_specs=...)`` on the qwen smoke blocks, f32
    and over a bf16 exchange.

* A subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=
  4`` executes the reference's OWN partitioned lowerable on a 2×2 CPU
  mesh, dense and 'permute', the reference's permute gossip with
  ``leaf_specs`` on the same mesh (2 agents a side: the port's world has
  4 ranks), two of the reference's tree rounds and its models' logits
  and losses.

* In this process: the rest of the reference's rounds and results, the
  refusals of the families outside the slice (the forward under a model
  group, the lowerable), the permute gossip's refusal of a spec without
  the agent dim, and the partitioned tree program's trace and dry-run
  record on the 16 × 16 mesh.

Tolerances: layers within 1e-5·max|y|, logits 1e-4·max|logit|, losses
1e-5 relative, rounds' end states 1e-5·max|x|; the lossy codecs' twin
cells with tests/test_torch_sharded.py's rule (99% of x within
1e-5·max|x|, every element within the codec's rounding step); the
permute gossip 1e-6·max|y| (f32) and the reference's own 2e-2 (bf16
exchange).  The spawned ranks import this module: its module level
imports no jax.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import FedConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import feddec, gossip, sharded
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.mixing import MixingDistribution
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.train import tiny_lm_config
from repro_torch.models import attention, build_model, layers
from repro_torch.sharding import tp
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESHES = ((1, 2), (2, 2), (1, 4))
TOL, LOGIT_TOL = 1e-5, 1e-4
N, H, K, T, B, S, LR, P_FAIL = 4, 2, 2, 2, 1, 8, 0.05, 0.1
KEY_SEED = 7
IMPLS = ("dense", "pallas", "sparse")
ROUND_CASES = ("tiny", "qwen1.5-4b", "gemma3-12b", "nemotron-4-15b",
               "heads6-kv3", "heads3-kv3")
# the reference's rounds computed by the subprocess (the rest here)
SUB_CASES = ("gemma3-12b", "nemotron-4-15b")
# (case, mesh, impl, optimizer, codec) held to the port's one-device twin
TWIN_CELLS = (("qwen1.5-4b", (2, 2), "dense", "momentum", "none"),
              ("gemma3-12b", (1, 2), "pallas", "adamw", "none"),
              ("tiny", (2, 2), "sparse", "sgd", "int8"),
              ("nemotron-4-15b", (1, 4), "dense", "sgd", "bf16"),
              ("qwen1.5-4b", (1, 2), "none", "sgd", "none"))
MODEL_CASES = ("tiny", "qwen1.5-4b", "gemma3-12b", "nemotron-4-15b",
               "heads4-kv2", "heads6-kv3", "heads3-kv3")
# attention layouts: (case, M) → the reference's branch
ATTN_CASES = {("heads4-kv2", 2): "a", ("heads6-kv3", 2): "b",
              ("heads3-kv3", 2): "c", ("heads3-kv3", 4): "c",
              ("tiny", 2): "b", ("tiny", 4): "c"}
MLP_KINDS = ("swiglu", "geglu", "relu2", "gelu")
LOW_SHAPE = ("t", 32, 4, "train")     # name, seq, global batch, kind
OUTSIDE = ("mistral-large-123b", "deepseek-v3-671b")


def _case_cfg(name: str, side: str = "port"):
    """A case's config on the port's or the reference's side."""
    if side == "port":
        tiny, zoo = tiny_lm_config, get_config
    else:
        from repro.configs import get_config as zoo
        from repro.launch.train import tiny_lm_config as tiny
    base = tiny(d_model=128, layers=2, vocab=256)
    hand = {"heads4-kv2": (4, 2, 32), "heads6-kv3": (6, 3, 16),
            "heads3-kv3": (3, 3, 16)}
    if name == "tiny":
        return base
    if name in hand:
        h, kv, hd = hand[name]
        return dataclasses.replace(base, name=name, num_layers=1,
                                   num_heads=h, num_kv_heads=kv,
                                   head_dim=hd)
    return zoo(name).smoke()


def _axes(a: int, m: int) -> shd.MeshAxes:
    return shd.MeshAxes(("agents",), "model", {"agents": a, "model": m})


def _tp_cfg(name: str, m: int):
    return steps.adapt_for_mesh(_case_cfg(name), _axes(1, m))


def _stacked_start(name: str, seed: int = 0) -> dict:
    """n agents' random start (numpy): the port's init, every agent
    perturbed on its own."""
    params = build_model(_case_cfg(name)).init(Draws(seed, "cpu"))
    rng = np.random.default_rng(seed + 1)
    return tree_map(lambda p: (p.numpy()[None] + 0.01 * rng.standard_normal(
        (N,) + tuple(p.shape))).astype(np.float32), params)


def _batches(name: str, steps_: int = T, n: int = N, b: int = B,
             s: int = S, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    vocab = _case_cfg(name).vocab_size
    return {"tokens": rng.integers(0, vocab, (steps_, n, b, s)),
            "positions": np.broadcast_to(np.arange(s),
                                         (steps_, n, b, s)).copy()}


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


class TableDraws:
    """The reference's draws served from tables keyed by the step t."""

    def __init__(self, tables):
        self.tables = tables

    def link_uniforms(self, t, n):
        return torch.from_numpy(self.tables["links"][int(t)])

    def participants(self, t, n, k):
        return torch.from_numpy(self.tables["parts"][int(t)])


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                    tree)


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _mesh(a: int, m: int):
    """The (a, m) ('agents', 'model') mesh of this world, or of each of
    its replicas when a·m is smaller than the world."""
    import torch.distributed as dist
    if a * m == dist.get_world_size():
        return mesh_lib.make_fed_mesh(a, m, device="cpu")
    from torch.distributed.device_mesh import init_device_mesh
    rep = dist.get_world_size() // (a * m)
    return init_device_mesh("cpu", (rep, a, m), mesh_dim_names=(
        "rep", "agents", "model"))["agents", "model"]


def _gather_model(x: torch.Tensor, g, full: int, dim: int = -1):
    """The whole of a model-sharded activation (a no-op when whole)."""
    if x.shape[dim] == full:
        return x
    return tp._gather(x, g, dim % x.ndim)


def _blocks(tree: dict, cfg, mesh) -> dict:
    """This rank's blocks of an unstacked tree (its specs as the one
    agent of a stacked one)."""
    stacked = tree_map(lambda a: a[None], tree)
    specs = shd.param_pspecs(cfg, stacked, tp.mesh_axes(mesh))
    return tree_map(lambda a: a[0], tp.shard_params(stacked, specs, mesh))


def _run_layers(inp: dict, mesh) -> dict:
    """The layers, attention layouts and models on this rank's blocks,
    their outputs made whole."""
    g = tp.ModelGroup.of(mesh)
    m = g.size
    cfg = _tp_cfg("tiny", m)
    d, f = inp["x"].shape[-1], inp["wi"].shape[-1]
    x, h = torch.from_numpy(inp["x"]), torch.from_numpy(inp["h"])
    out = {}
    blk = _blocks({"mlp": {"wi": {"w": torch.from_numpy(inp["wi"])},
                           "wo": {"w": torch.from_numpy(inp["wo"])}}},
                  cfg, mesh)["mlp"]
    out["column"] = _gather_model(layers.dense(
        blk["wi"], x, tp=g, parallel="column"), g, f)
    cols = slice(g.rank * f // m, (g.rank + 1) * f // m)
    out["row"] = layers.dense(blk["wo"], h[..., cols], tp=g, parallel="row")
    for kind in MLP_KINDS:
        p = _blocks({"mlp": _torch(inp["mlp"][kind])}, cfg, mesh)["mlp"]
        out[f"mlp-{kind}"] = layers.mlp(p, x, kind, tp=g, d_ff=f)
    emb = _blocks({"embed": {"table": torch.from_numpy(inp["table"])}}, cfg,
                  mesh)["embed"]
    vocab = inp["table"].shape[0]
    out["embed"] = layers.embed(emb, torch.from_numpy(inp["tokens"]), tp=g,
                                vocab=vocab)
    head = _blocks({"head": {"w": torch.from_numpy(inp["head"])}}, cfg,
                   mesh)["head"]
    out["unembed"] = _gather_model(layers.unembed(head, x, tp=g, vocab=vocab),
                                   g, vocab)
    for (name, mm), _ in ATTN_CASES.items():
        if mm != m:
            continue
        acfg = _tp_cfg(name, m)
        p = _blocks({"attn": _torch(inp["attn"][name])}, acfg, mesh)["attn"]
        y, _ = attention.attention(
            p, x, torch.from_numpy(inp["positions"]), head_dim=acfg.head_dim,
            tp=g, num_heads=acfg.num_heads, num_kv_heads=acfg.num_kv_heads,
            weight_gather=acfg.attn_weight_gather)
        out[f"attn-{name}"] = y
    batch = _torch(inp["model_batch"])
    for name in MODEL_CASES:
        mcfg = _tp_cfg(name, m)
        model = build_model(mcfg)
        p = _blocks(_torch(inp["model_params"][name]), mcfg, mesh)
        with tp.model_group(mesh):
            logits = model.logits(p, batch)
            loss = model.loss(p, batch)
        out[f"logits-{name}"] = _gather_model(logits, g, mcfg.vocab_size)
        out[f"loss-{name}"] = loss
    return _numpy(out)


def _round_setup(name: str, impl: str, codec: str = "none"):
    cfg = _case_cfg(name)
    fcfg = feddec.FedDecConfig(
        mixing=MixingDistribution(topo.ring_graph(N, k=1), p_fail=P_FAIL,
                                  scheme="metropolis"), h=H, k=K,
        gossip_impl=impl, gossip_compress=codec)
    return cfg, fcfg


def _opt(name):
    """The cell's optimizer; adamw's ε is 1e-2, so that its step is a
    smooth function of the gradient (at ε 1e-8 a gradient near 0 that two
    summation orders give different signs moves its element by 2η)."""
    return {"sgd": None, "momentum": optim.momentum_sgd(),
            "adamw": optim.adamw(eps=1e-2, weight_decay=0.01)}[name]


def _block_bytes(state) -> tuple:
    """(bytes of the blocks' elements, bytes of their storages)."""
    ts = [*leaves(state.params), *leaves(state.opt_state),
          *leaves(state.residual)]
    ts = [t for t in ts if isinstance(t, torch.Tensor) and t.ndim > 1]
    return (sum(t.numel() * t.element_size() for t in ts),
            sum(t.untyped_storage().nbytes() for t in ts))


def _expected_bytes(name: str, mesh, n_trees: int) -> int:
    """Σ over leaves of (n/A)·numel/M_leaf f32 elements × 4 bytes, for
    ``n_trees`` trees of the parameters' layout."""
    cfg = _case_cfg(name)
    shapes = feddec.init_state(build_model(cfg).init_shapes(), N).params
    specs = shd.param_pspecs(cfg, shapes, tp.mesh_axes(mesh))
    sizes = tp.mesh_axes(mesh).sizes
    per = sum(tp.block_numel(tuple(s.shape), sp, sizes)
              for s, sp in zip(leaves(shapes), leaves(specs)))
    return 4 * per * n_trees


def _start_state(start, opt, codec):
    """A FedState of the stacked numpy start, its optimizer slots and
    residual zero."""
    params = _torch(start)
    state = feddec.init_state(tree_map(lambda a: a[0], params), N,
                              optimizer=opt, compress=codec)
    state.params = params
    return state


def _run_tp_round(name, mesh, impl, opt_name, codec, start, batches, draws):
    """This rank's tensor-parallel tree round: the gathered end state,
    the losses and this rank's bytes."""
    a = mesh.get_local_rank("agents")
    n_local = N // int(mesh.mesh.shape[0])
    cfg, fcfg = _round_setup(name, impl, codec)
    tcfg = steps.adapt_for_mesh(cfg, tp.mesh_axes(mesh))
    opt = _opt(opt_name)
    state = _start_state(start, opt, codec)
    specs = shd.param_pspecs(tcfg, state.params, tp.mesh_axes(mesh))
    blk = sharded.shard_tree_state(state, specs, mesh)
    rnd = sharded.make_sharded_tree_round(
        fcfg, build_model(tcfg).grad_fn(), lambda t: LR, mesh, device="cpu",
        param_specs=specs, optimizer=opt)
    rows = slice(a * n_local, (a + 1) * n_local)
    blk, met = rnd(blk, {k: torch.from_numpy(v[:, rows])
                         for k, v in batches.items()}, draws)
    nbytes = _block_bytes(blk)
    whole = sharded.gather_tree_state(blk, specs, mesh)
    return {"params": _numpy(whole.params), "losses": met["loss"].tolist(),
            "bytes": nbytes,
            "opt": _numpy(whole.opt_state) if opt_name != "sgd" else ()}


def _run_twin(name, impl, opt_name, codec, start, batches, draws):
    """The port's one-device tree round of a twin cell."""
    cfg, fcfg = _round_setup(name, impl, codec)
    opt = _opt(opt_name)
    state = _start_state(start, opt, codec)
    rnd = feddec.make_feddec_round(fcfg, build_model(cfg).grad_fn(),
                                   lambda t: LR, optimizer=opt, device="cpu")
    state, met = rnd(state, _torch(batches), draws)
    return {"params": _numpy(state.params), "losses": met["loss"].tolist(),
            "opt": _numpy(state.opt_state) if opt_name != "sgd" else ()}


def _run_lowerable(inp, impl: str) -> dict:
    """The port's partitioned training lowerable at (2, 2), executed on
    the reference's start, batches and draws; gathered."""
    low_in = inp["lowerable"]
    cfg = _case_cfg("qwen1.5-4b")
    axes = shd.MeshAxes(("data",), "model", {"data": 2, "model": 2})
    low = steps.build_train_lowerable(
        cfg, ShapeConfig(*LOW_SHAPE), axes, mesh=axes, fused_steps=H,
        fed=FedConfig(h=H, k=2, gossip_impl=impl))
    fn = low.make_fn(torch.device("cpu"))
    mesh = mesh_lib.make_fed_mesh(2, 2, device="cpu")
    tcfg = steps.adapt_for_mesh(cfg, axes)
    start = _torch(low_in["start"])
    specs = shd.param_pspecs(tcfg, start, tp.mesh_axes(mesh))
    state = sharded.shard_tree_state(feddec.FedState(params=start, step=1),
                                     specs, mesh)
    a = mesh.get_local_rank("agents")
    batch = {k: torch.from_numpy(v[:, a:a + 1])
             for k, v in low_in["batches"].items()}
    state, met = fn(state, batch, TableDraws(low_in["tables"]))
    whole = sharded.gather_tree_state(state, specs, mesh)
    return {"params": _numpy(whole.params), "losses": met["loss"].tolist(),
            "world": low.world}


def _run_permute(inp) -> dict:
    """make_permute_gossip(leaf_specs=...) at (2, 2) on the qwen smoke
    blocks, f32 and over a bf16 exchange, gathered."""
    per = inp["permute"]
    mesh = mesh_lib.make_fed_mesh(2, 2, device="cpu")
    tcfg = steps.adapt_for_mesh(_case_cfg("qwen1.5-4b"),
                                tp.mesh_axes(mesh))
    stacked = _torch(per["stacked"])
    specs = shd.param_pspecs(tcfg, stacked, tp.mesh_axes(mesh))
    blk = tp.shard_params(stacked, specs, mesh)
    out = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        fn = gossip.make_permute_gossip(topo.Graph(per["adjacency"]), mesh,
                                        "agents", leaf_specs=specs,
                                        exchange_dtype=dtype)
        y = fn(torch.from_numpy(per["w"]), blk)
        out[label] = _numpy(tp.gather_params(y, specs, mesh))
    return out


def _wait_for(path: str, timeout: float = 300.0):
    """The pickle at ``path`` once its writer has renamed it into place
    (the ranks and the subprocess start while the parent makes their
    inputs)."""
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _world_main(rank, world, store_path, inputs_path, out_path):
    """One rank of the spawned gloo world; rank 0 writes what every rank
    reported."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        inp = _wait_for(inputs_path)
        mine = {}
        for a, m in MESHES:
            mesh = _mesh(a, m)
            if a == 1:
                mine[("layers", m)] = _run_layers(inp["layers"], mesh)
            for i, name in enumerate(ROUND_CASES):
                impl = IMPLS[(i + MESHES.index((a, m))) % len(IMPLS)]
                mine[("round", name, a, m)] = _run_tp_round(
                    name, mesh, impl, "sgd", "none", inp["start"][name],
                    inp["batches"][name], TableDraws(inp["tables"]))
            for cell in TWIN_CELLS:
                name, shape, impl, opt_name, codec = cell
                if shape == (a, m):
                    mine[("twin-tp",) + cell] = _run_tp_round(
                        name, mesh, impl, opt_name, codec,
                        inp["start"][name], inp["batches"][name],
                        Draws(11, "cpu"))
            if (a, m) == (2, 2):
                for impl in ("dense", "permute"):
                    mine[("lowerable", impl)] = _run_lowerable(inp, impl)
                mine["permute"] = _run_permute(inp)
        if rank:
            # rank 0 reports the gathered states; the others what is
            # their own (losses, bytes)
            mine = {k: {f: v for f, v in r.items()
                        if f in ("losses", "bytes")}
                    for k, r in mine.items()
                    if isinstance(k, tuple) and k[0] in ("round",
                                                         "twin-tp")}
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side (this process and the subprocess)
# ---------------------------------------------------------------------------


def _ref_tables(key_seed: int, t_steps: int, n: int, k: int,
                p_fail: float) -> dict:
    """The reference tree engine's draws of steps 1..t_steps from
    ``key(key_seed)``: W's link uniforms and the server's participants
    (``split(fold_in(key, t), 3)``), as numpy keyed by t."""
    import jax

    @jax.jit
    def draw(t):
        kk = jax.random.split(jax.random.fold_in(jax.random.key(key_seed),
                                                 t), 3)
        return (jax.random.randint(kk[2], (k,), 0, n),
                jax.random.uniform(kk[0], (n, n)))

    out = {t: jax.tree.map(np.asarray, draw(t))
           for t in range(1, t_steps + 1)}
    return {"parts": {t: p.astype(np.int64) for t, (p, _) in out.items()},
            "links": {t: u for t, (_, u) in out.items()} if p_fail > 0
            else {}}


def _layer_inputs() -> dict:
    rng = np.random.default_rng(0)
    d, f, vocab = 128, 256, 256

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    inp = {"x": normal(2, S, d), "h": normal(2, S, f),
           "wi": normal(d, f, scale=d ** -0.5),
           "wo": normal(f, d, scale=f ** -0.5),
           "table": normal(vocab, d, scale=0.02),
           "head": normal(d, vocab, scale=d ** -0.5),
           "tokens": rng.integers(0, vocab, (2, S)),
           "positions": np.broadcast_to(np.arange(S), (2, S)).copy(),
           "mlp": {}, "attn": {}, "model_params": {}}
    for kind in MLP_KINDS:
        p = {"wi": {"w": normal(d, f, scale=d ** -0.5)},
             "wo": {"w": normal(f, d, scale=f ** -0.5)}}
        if kind in ("swiglu", "geglu"):
            p["wg"] = {"w": normal(d, f, scale=d ** -0.5)}
        inp["mlp"][kind] = p
    for name in {c for c, _ in ATTN_CASES}:
        cfg = _case_cfg(name)
        hq, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        inp["attn"][name] = {
            "wq": {"w": normal(d, hq, hd, scale=d ** -0.5),
                   "b": normal(hq, hd, scale=0.1)},
            "wk": {"w": normal(d, kv, hd, scale=d ** -0.5),
                   "b": normal(kv, hd, scale=0.1)},
            "wv": {"w": normal(d, kv, hd, scale=d ** -0.5),
                   "b": normal(kv, hd, scale=0.1)},
            "wo": {"w": normal(hq, hd, d, scale=(hq * hd) ** -0.5)}}
    for name in MODEL_CASES:
        params = build_model(_case_cfg(name)).init(Draws(5, "cpu"))
        inp["model_params"][name] = tree_map(
            lambda p: (p.numpy() + 0.01 * rng.standard_normal(p.shape)
                       ).astype(np.float32), params)
    inp["model_batch"] = {"tokens": rng.integers(0, 256, (2, S)),
                          "positions": inp["positions"]}
    return inp


def _inputs() -> dict:
    """Every input of the ranks and the subprocess (numpy)."""
    inp = {"layers": _layer_inputs(), "start": {}, "batches": {},
           "tables": _ref_tables(KEY_SEED, T, N, K, P_FAIL)}
    for name in ROUND_CASES:
        inp["start"][name] = _stacked_start(name)
        inp["batches"][name] = _batches(name)
    inp["lowerable"] = {
        "start": tree_map(lambda a: a[:2], _stacked_start("qwen1.5-4b", 9)),
        "batches": _batches("qwen1.5-4b", H, 2, 2, LOW_SHAPE[1], seed=4),
        "tables": _ref_tables(KEY_SEED, H, 2, 2, 0.0)}
    rng = np.random.default_rng(8)
    inp["permute"] = {
        "stacked": tree_map(lambda a: a[:2] + 0.1 * rng.standard_normal(
            a[:2].shape).astype(np.float32), _stacked_start("qwen1.5-4b")),
        "adjacency": np.array([[False, True], [True, False]]),
        "w": np.array([[0.7, 0.3], [0.4, 0.6]], np.float32)}
    return inp


def _ref_round(name: str, inp: dict) -> dict:
    """The reference's tree round of a case on one device, its draws
    from ``key(KEY_SEED)``."""
    import jax
    import jax.numpy as jnp
    from repro.core import feddec as ref_feddec
    from repro.core import topology as ref_topo
    from repro.core.mixing import MixingDistribution as RefMixing
    from repro.models import build_model as ref_build_model
    cfg = _case_cfg(name, "ref")
    rcfg = ref_feddec.FedDecConfig(
        mixing=RefMixing(ref_topo.ring_graph(N, k=1), p_fail=P_FAIL,
                         scheme="metropolis"), h=H, k=K)
    state = ref_feddec.FedState(
        params=jax.tree.map(jnp.asarray, inp["start"][name]),
        step=jnp.asarray(1, jnp.int32), opt_state=(), residual=())
    rnd = ref_feddec.make_feddec_round(
        rcfg, ref_build_model(cfg).grad_fn(),
        lambda t: jnp.asarray(LR, jnp.float32), donate=False)
    state, met = rnd(state, jax.tree.map(jnp.asarray, inp["batches"][name]),
                     jax.random.key(KEY_SEED))
    return {"params": jax.tree.map(np.asarray, state.params),
            "losses": np.asarray(met["loss"]).tolist()}


def _ref_layers(inp: dict) -> dict:
    """The reference's single-device layers on the whole weights (one
    jitted program)."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ref_attn
    from repro.models import layers as ref_layers
    arrays = {k: v for k, v in inp.items() if k not in ("model_params",
                                                        "model_batch")}
    cfgs = {name: _case_cfg(name, "ref") for name, _ in ATTN_CASES}

    def compute(a):
        x = a["x"]
        out = {"column": ref_layers.dense({"w": a["wi"]}, x),
               "row": ref_layers.dense({"w": a["wo"]}, a["h"]),
               "embed": ref_layers.embed({"table": a["table"]},
                                         a["tokens"]),
               "unembed": ref_layers.unembed({"w": a["head"]}, x)}
        for kind in MLP_KINDS:
            out[f"mlp-{kind}"] = ref_layers.mlp(a["mlp"][kind], x, kind)
        for name, cfg in cfgs.items():
            out[f"attn-{name}"], _ = ref_attn.attention(
                a["attn"][name], x, a["positions"],
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                compute_dtype=jnp.float32)
        return out

    return jax.tree.map(np.asarray, jax.jit(compute)(
        jax.tree.map(jnp.asarray, arrays)))


def _ref_models(inp: dict) -> dict:
    """The reference's logits and loss of each model case."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as ref_build_model
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    batch, out = j(inp["model_batch"]), {}
    for name in MODEL_CASES:
        model = ref_build_model(_case_cfg(name, "ref"))
        out[f"logits-{name}"], out[f"loss-{name}"] = jax.jit(
            lambda p, b: (model.logits(p, b)[0], model.loss(p, b)))(
            j(inp["model_params"][name]), batch)
    return jax.tree.map(np.asarray, out)


def _ref_subprocess_main(inputs_path: str, out_path: str) -> None:
    """The subprocess: the reference's partitioned lowerable on a 2×2 CPU
    mesh (dense, 'permute'), its permute gossip with leaf_specs (f32,
    bf16 exchange) and its tree rounds of SUB_CASES."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import sharding as ref_shd
    from repro.configs.base import FedConfig as RefFed
    from repro.configs.shapes import ShapeConfig as RefShape
    from repro.core import feddec as ref_feddec
    from repro.core import gossip as ref_gossip
    from repro.core import topology as ref_topo
    from repro.launch import steps as ref_steps
    inp = _wait_for(inputs_path)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    axes = ref_shd.axes_for_mesh(mesh)
    cfg = _case_cfg("qwen1.5-4b", "ref")
    out = {}

    def place(tree, specs):
        return jax.tree.map(
            lambda a, s: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, s)),
            tree, specs, is_leaf=lambda x: isinstance(x, P))

    low_in = inp["lowerable"]
    for impl in ("dense", "permute"):
        low = ref_steps.build_train_lowerable(
            cfg, RefShape(*LOW_SHAPE), axes, mesh=mesh, fused_steps=H,
            fed=RefFed(h=H, k=2, gossip_impl=impl))
        compiled = low.lower(mesh).compile()
        specs = low.in_specs
        state = ref_feddec.FedState(
            params=place(low_in["start"], specs[0].params),
            step=jnp.asarray(1, jnp.int32), opt_state=(), residual=())
        batch = place(low_in["batches"], specs[1])
        state, met = compiled(state, batch, jax.random.key(KEY_SEED))
        out[("lowerable", impl)] = {
            "params": jax.tree.map(np.asarray, state.params),
            "losses": np.asarray(met["loss"]).tolist()}
    per = inp["permute"]
    specs = ref_shd.param_pspecs(cfg, per["stacked"], axes)
    stacked = place(per["stacked"], specs)
    out["permute"] = {}
    for label, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        fn = ref_gossip.make_permute_gossip(
            ref_topo.ring_graph(2, k=1), mesh, "data", leaf_specs=specs,
            exchange_dtype=dtype)
        out["permute"][label] = jax.tree.map(
            np.asarray, jax.jit(fn)(jnp.asarray(per["w"]), stacked))
    for name in SUB_CASES:
        out[("round", name)] = _ref_round(name, inp)
    out["models"] = _ref_models(inp["layers"])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's report, the subprocess's and this process's reference
    results: the world and the subprocess run while this process
    computes its share."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tp")
    inputs, out_path, sub_out = (tmp / "inputs.pkl", tmp / "out.pkl",
                                 tmp / "ref.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    sub = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, test_torch_tensor_parallel as t; "
         "t._ref_subprocess_main(sys.argv[1], sys.argv[2])",
         str(inputs), str(sub_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx = mp.start_processes(
        _world_main, args=(WORLD, str(tmp / "store"), str(inputs),
                           str(out_path)),
        nprocs=WORLD, start_method="spawn", join=False)
    # the inputs while the ranks and the subprocess start, torch on one
    # thread beside them (restored after)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = _inputs()
        with open(tmp / "inputs.tmp", "wb") as f:
            pickle.dump(inp, f)
        os.replace(tmp / "inputs.tmp", inputs)
        want = {("twin",) + cell: _run_twin(
            cell[0], *cell[2:], inp["start"][cell[0]],
            inp["batches"][cell[0]], Draws(11, "cpu"))
            for cell in TWIN_CELLS}
    finally:
        torch.set_num_threads(threads)
    want.update({("round", n): _ref_round(n, inp) for n in ROUND_CASES
                 if n not in SUB_CASES})
    want["layers"] = _ref_layers(inp["layers"])
    while not ctx.join():
        pass
    _, err = sub.communicate(timeout=300)
    assert sub.returncode == 0, err[-4000:]
    with open(sub_out, "rb") as f:
        want.update(pickle.load(f))
    want["layers"].update(want.pop("models"))
    with open(out_path, "rb") as f:
        every = pickle.load(f)
    return {"ranks": every, "want": want, "inputs": inp}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _flat_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _flat_leaves(tree[k])]
    return [np.asarray(tree)]


def _max_err(got, want) -> tuple:
    gl, wl = _flat_leaves(got), _flat_leaves(want)
    assert [g.shape for g in gl] == [w.shape for w in wl]
    err = max(float(np.abs(g.astype(np.float64) - w).max())
              for g, w in zip(gl, wl))
    return err, max(float(np.abs(w).max()) for w in wl)


def _assert_close(got, want, tol):
    err, scale = _max_err(got, want)
    assert err <= tol * scale, f"{err:.3e} > {tol}·{scale:.3e}"


LAYER_KEYS = (["column", "row", "embed", "unembed"]
              + [f"mlp-{k}" for k in MLP_KINDS])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("key", LAYER_KEYS)
def test_tensor_parallel_layer_matches_reference(world, key, m):
    got = world["ranks"][0][("layers", m)][key]
    _assert_close(got, world["want"]["layers"][key], TOL)


@pytest.mark.parametrize("name,m", list(ATTN_CASES),
                         ids=[f"{n}-m{m}-{b}" for (n, m), b in
                              ATTN_CASES.items()])
def test_tensor_parallel_attention_matches_reference(world, name, m):
    """Attention in the reference's layouts (a), (b), (c) on the blocks,
    against its single-device function."""
    cfg = _tp_cfg(name, m)
    branch = ATTN_CASES[(name, m)]
    assert branch == ("c" if cfg.attn_weight_gather else
                      "a" if cfg.num_kv_heads % m == 0 else "b")
    got = world["ranks"][0][("layers", m)][f"attn-{name}"]
    _assert_close(got, world["want"]["layers"][f"attn-{name}"], TOL)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", MODEL_CASES)
def test_tensor_parallel_logits_and_loss_match_reference(world, name, m):
    """The model's logits (made whole over the vocabulary blocks) within
    1e-4·max|logit|, the vocabulary-parallel loss within 1e-5, the same
    on every rank of the group (counted once)."""
    out = world["ranks"][0][("layers", m)]
    want = world["want"]["layers"]
    _assert_close(out[f"logits-{name}"], want[f"logits-{name}"], LOGIT_TOL)
    np.testing.assert_allclose(out[f"loss-{name}"], want[f"loss-{name}"],
                               rtol=TOL)
    for rank in world["ranks"][1:]:
        if ("layers", m) in rank:
            assert rank[("layers", m)][f"loss-{name}"] == \
                out[f"loss-{name}"]


ROUND_IDS = [(name, a, m) for (a, m) in MESHES for name in ROUND_CASES]


@pytest.mark.parametrize("name,a,m", ROUND_IDS,
                         ids=[f"{n}-{a}x{m}" for n, a, m in ROUND_IDS])
def test_tensor_parallel_tree_round_matches_reference(world, name, a, m):
    """The TP tree round against the reference's one-device tree round
    (end state 1e-5·max|x|, losses 1e-5), and each rank's state exactly
    its blocks."""
    want = world["want"][("round", name)]
    for rank, rep in enumerate(world["ranks"]):
        got = rep[("round", name, a, m)]
        if rank == 0:
            _assert_close(got["params"], want["params"], TOL)
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=TOL)
        assert got["losses"] == world["ranks"][0][
            ("round", name, a, m)]["losses"]


@pytest.mark.parametrize("cell", TWIN_CELLS,
                         ids=["-".join(map(str, c)) for c in TWIN_CELLS])
def test_tensor_parallel_tree_round_matches_one_device_twin(world, cell):
    """Optimizers, codecs and 'none' against the port's one-device tree
    round on the same draws: uncompressed within 1e-5·max|x| (momentum's
    slot and adamw's m and v within 1e-5·max, adamw's count exact), int8
    and bf16 by the lossy rule (losses 1e-4)."""
    got = world["ranks"][0][("twin-tp",) + cell]
    want = world["want"][("twin",) + cell]
    codec = cell[4]
    if codec == "none":
        _assert_close(got["params"], want["params"], TOL)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        if cell[3] == "momentum":
            _assert_close(got["opt"], want["opt"], TOL)
        elif cell[3] == "adamw":
            _assert_close(got["opt"]["m"], want["opt"]["m"], TOL)
            _assert_close(got["opt"]["v"], want["opt"]["v"], TOL)
            np.testing.assert_array_equal(got["opt"]["count"],
                                          want["opt"]["count"])
        return
    gl, wl = _flat_leaves(got["params"]), _flat_leaves(want["params"])
    scale = max(float(np.abs(w).max()) for w in wl)
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(gl, wl)])
    step = scale / 127 if codec == "int8" else scale * 2.0 ** -7
    assert np.mean(diff <= TOL * scale) >= 0.99
    assert diff.max() <= step, f"{diff.max():.3e} > {step:.3e}"
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


@pytest.mark.parametrize("name,a,m", ROUND_IDS,
                         ids=[f"{n}-{a}x{m}" for n, a, m in ROUND_IDS])
def test_each_rank_holds_exactly_its_blocks(world, name, a, m):
    want = _expected_bytes(name, types.SimpleNamespace(
        mesh_dim_names=("agents", "model"), mesh=np.zeros((a, m))), 1)
    for rep in world["ranks"]:
        elems, storage = rep[("round", name, a, m)]["bytes"]
        assert elems == storage == want


@pytest.mark.parametrize("impl", ["dense", "permute"])
def test_partitioned_lowerable_matches_the_references_own(world, impl):
    """The port's build_train_lowerable(state_layout='tree', 2×2 mesh)
    executed in the gloo world against the reference's own partitioned
    lowerable executed on a 2×2 CPU mesh: end state 1e-5·max|x|, losses
    1e-5."""
    got = world["ranks"][0][("lowerable", impl)]
    want = world["want"][("lowerable", impl)]
    assert got["world"] == 4
    _assert_close(got["params"], want["params"], TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)


@pytest.mark.parametrize("label,tol", [("f32", 1e-6), ("bf16", 2e-2)])
def test_permute_gossip_leaf_specs_matches_reference(world, label, tol):
    got = world["ranks"][0]["permute"][label]
    _assert_close(got, world["want"]["permute"][label], tol)


# ---------------------------------------------------------------------------
# in this process: refusals, the trace and the dry-run record
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group():
    """An ambient model group of 2 ranks that no collective reaches: the
    refusals raise before any."""
    tp._ACTIVE["model"] = tp.ModelGroup(None, 0, 2)
    yield
    tp._ACTIVE.pop("model", None)


@pytest.mark.parametrize("arch", OUTSIDE)
def test_families_outside_the_slice_refuse_a_model_axis(arch, fake_group):
    cfg = dataclasses.replace(get_config(arch).smoke(), tp_axis_name="model")
    model = build_model(cfg)
    params = model.init_shapes()
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long,
                                   device="meta"),
             "positions": torch.zeros((1, 8), dtype=torch.long,
                                      device="meta")}
    with pytest.raises(NotImplementedError, match=r"Queue A item 6\.\d"):
        model.logits(params, batch)
    axes = shd.MeshAxes(("data",), "model", {"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match=r"Queue A item 6\.\d"):
        steps.build_train_lowerable(get_config(arch).smoke(),
                                    ShapeConfig("t", 8, 4, "train"), axes,
                                    mesh=axes)


def test_permute_gossip_refuses_a_spec_without_the_agent_dim():
    with pytest.raises(ValueError, match="dim 0 on 'agents'"):
        gossip.make_permute_gossip(topo.ring_graph(4, k=1), None, "agents",
                                   leaf_specs={"w": (None, "model")})


def test_tree_lowerable_traces_rank_zero_of_the_partitioned_world():
    """The tiny LM's tree step on the 16 × 16 mesh at a cut shape: rank 0
    of 256 fake ranks, one agent a mesh row, each leaf its block, the
    model's collectives on the model group; 'permute' traces too."""
    import torch.distributed as dist
    axes = shd.MeshAxes(("data",), "model", {"data": 16, "model": 16})
    cfg = tiny_lm_config(d_model=128, layers=1, vocab=256)
    low = steps.build_train_lowerable(cfg, ShapeConfig("t", 16, 32, "train"),
                                      axes, mesh=axes)
    lowered = low.lower()
    assert not dist.is_initialized() and low.world == 256
    table = lowered.outputs[0].params["embed"]["table"]
    assert tuple(table.shape) == (1, 256 // 16, 128)
    counts = lowered.costs.collective_counts
    assert counts["all-reduce"] > 0 and counts["reduce-scatter"] > 0
    small = shd.MeshAxes(("data",), "model", {"data": 4, "model": 2})
    low = steps.build_train_lowerable(
        cfg, ShapeConfig("t", 16, 8, "train"), small, mesh=small,
        fed=FedConfig(gossip_impl="permute"))
    assert low.world == 8
    assert low.lower().costs.collective_counts["collective-permute"] > 0


def test_dryrun_tree_record_is_the_partitioned_program(tmp_path,
                                                       monkeypatch):
    from repro_torch.launch import dryrun
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 16, 32, "train"))
    monkeypatch.setattr(dryrun, "get_config", lambda arch: tiny_lm_config(
        d_model=128, layers=1, vocab=256))
    rec = dryrun.run_one("tiny", "train_4k", False, str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["tensor_parallel"] is True
