"""The port's agent-sharded flat engine and lattice against the JAX
package's engines.

* The host-side tables (quotient graph, cut edges, boundary rows, the
  permutation schedule) equal the reference's.
* Spawned gloo worlds of 2 and 4 ranks (one world per size, started once
  for the module by a fixture that runs every case and returns the
  gathered results) run the port's sharded round, its one-step executor
  and its sharded R = 2 lattice on a small quadratic (8 agents, D 220)
  over graphs {ring2, a geographic graph with ragged boundaries},
  p_fail {0, 0.3}, gossip impls {none, dense, sparse, pallas} (the plain
  versions of kernels #1 and #5 on the CPU), codecs {none, int8, topk,
  bf16}, sgd, momentum and adamw, the server on and off.  Each case is
  held to the reference's flat engine (its sweep engine for a lattice),
  run in this process under the same replayed draws, within
  1e-5·max|x| on the buffer, the optimizer state and the residual, and
  the losses within 1e-5 relative: the reference's own contract is
  sharded ≡ flat within 1e-5.  The ranks draw from tables of the
  reference's draws made here (:class:`TableDraws`), the full draw on
  every rank, as the port's engine expects.
* A world of one (in this process) runs the sharded engine with no
  collective at all, as the card's phase does.
* One case against the reference's own sharded round on 4 forced host
  devices, in a subprocess.
* The CLI's ``--mesh-agents 2 --device cpu`` under torchrun prints the
  flat run's lines; a wrong world size is refused.
"""

from __future__ import annotations

import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import flat as ref_flat
from repro.core import sharded as ref_sharded
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro_torch import optim
from repro_torch.core import engine, flat as flat_lib, sharded, sweep
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_map
from test_torch_engine import ref_codec_noise
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, H, ROUNDS, K, ETA = 8, 3, 2, 3, 0.05
SHAPES = {"b": (37,), "w": {"k": (3, 61)}}   # D = 220
TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The host-side tables
# ---------------------------------------------------------------------------


def _graph_pair(kind: str, n: int, seed: int = 0):
    if kind == "ring":
        g = ref_topo.ring_graph(n, k=2)
    else:
        g = ref_topo.geographic_graph(n, 0.7, seed=seed)
    return g, topo.Graph(np.asarray(g.adjacency), name=g.name)


TABLE_CASES = [("ring", 32, 8), ("geo", 8, 8), ("geo", 8, 4),
               ("ring", 8, 1), ("geo", 8, 2)]


@pytest.mark.parametrize("kind,n,shards", TABLE_CASES,
                         ids=[f"{k}{n}/{s}" for k, n, s in TABLE_CASES])
def test_host_tables_match_reference(kind, n, shards):
    ref_g, g = _graph_pair(kind, n)
    q_ref = ref_sharded.quotient_graph(ref_g, shards)
    q = sharded.quotient_graph(g, shards)
    np.testing.assert_array_equal(q.adjacency, np.asarray(q_ref.adjacency))
    assert q.name == q_ref.name
    assert sharded.cut_edge_stats(g, shards) == \
        ref_sharded.cut_edge_stats(ref_g, shards)
    split, ref_split = (sharded.boundary_row_split(g, shards),
                        ref_sharded.boundary_row_split(ref_g, shards))
    assert split.keys() == ref_split.keys()
    for key in split:
        np.testing.assert_array_equal(split[key], ref_split[key])
    for graph, ref_graph in ((g, ref_g), (q, q_ref)):
        sched = topo.permutation_schedule(graph)
        ref_sched = ref_topo.permutation_schedule(ref_graph)
        assert len(sched) == len(ref_sched)
        for a, b in zip(sched, ref_sched):
            np.testing.assert_array_equal(a, b)


def test_indivisible_shards_raise_the_reference_message():
    ref_g, g = _graph_pair("ring", 8)
    for fn in ("quotient_graph", "boundary_row_split"):
        with pytest.raises(ValueError) as ref_err:
            getattr(ref_sharded, fn)(ref_g, 3)
        with pytest.raises(ValueError) as err:
            getattr(sharded, fn)(g, 3)
        assert str(err.value) == str(ref_err.value)


def test_agent_mesh_needs_a_group_of_its_size():
    """make_agent_mesh and make_fed_mesh without an initialized group of
    their size raise with the reference's messages adapted to ranks (the
    2-D mesh's contracts: tests/test_torch_mesh2d.py)."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="need 1 <= n_shards <= 0 ranks"):
        mesh_lib.make_agent_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"n_agent_shards \* n_model_shards "
                                         r"== 0 ranks"):
        mesh_lib.make_fed_mesh(2, 2, device="cpu")


# ---------------------------------------------------------------------------
# The engine cases: the reference's flat (sweep) engine in this process
# ---------------------------------------------------------------------------

# (graph, p_fail, impl, codec, optimizer, server, executor)
CASES = {
    "ring-dense-sgd": ("ring", 0.0, "dense", "none", "sgd", True, "round"),
    "ring-sparse-momentum": ("ring", 0.0, "sparse", "none", "momentum",
                             True, "round"),
    "ring-pallas-sgd": ("ring", 0.0, "pallas", "none", "sgd", True,
                        "round"),
    "geo-pfail-pallas-adamw": ("geo", 0.3, "pallas", "none", "adamw", True,
                               "round"),
    "geo-pfail-sparse-sgd-noserver": ("geo", 0.3, "sparse", "none", "sgd",
                                      False, "round"),
    "geo-dense-momentum-step": ("geo", 0.0, "dense", "none", "momentum",
                                False, "step"),
    "ring-none-sgd": ("ring", 0.0, "none", "none", "sgd", True, "round"),
    "ring-pfail-pallas-int8": ("ring", 0.3, "pallas", "int8", "sgd", True,
                               "round"),
    "geo-sparse-int8-momentum": ("geo", 0.0, "sparse", "int8", "momentum",
                                 True, "round"),
    "ring-dense-int8-step": ("ring", 0.0, "dense", "int8", "sgd", True,
                             "step"),
    "geo-pallas-topk": ("geo", 0.0, "pallas", "topk:0.25", "sgd", True,
                        "round"),
    "ring-pfail-dense-topk-adamw": ("ring", 0.3, "dense", "topk:0.25",
                                    "adamw", False, "round"),
    "ring-sparse-bf16": ("ring", 0.0, "sparse", "bf16", "sgd", True,
                         "round"),
    "geo-pfail-pallas-bf16-step": ("geo", 0.3, "pallas", "bf16", "momentum",
                                   True, "step"),
    "ring-pallas-momentum-step": ("ring", 0.0, "pallas", "none", "momentum",
                                  True, "step"),
}
# the R = 2 lattice: (run configs as (graph, graph seed, H, impl), p_fail,
# codec, optimizer, per-run keys)
SWEEP_CASES = {
    "sweep-seed-pfail-pallas": ((("ring", 0, H, "pallas"),) * 2, 0.3,
                                "none", "sgd", True),
    "sweep-h-dense-momentum": ((("ring", 0, H, "dense"),
                                ("ring", 0, 2 * H, "dense")), 0.0, "none",
                               "momentum", False),
    "sweep-topology-sparse-int8": ((("geo", 0, H, "sparse"),
                                    ("geo", 1, H, "sparse")), 0.0, "int8",
                                   "sgd", False),
    "sweep-fedavg-pallas-int8": ((("ring", 0, H, "pallas"),
                                  ("ring", 0, H, "none")), 0.0, "int8",
                                 "momentum", True),
    "sweep-pallas-topk": ((("geo", 0, H, "pallas"),
                           ("geo", 0, 2 * H, "pallas")), 0.3, "topk:0.25",
                          "sgd", True),
}


def _jax_loss(params, batch):
    return 0.5 * (jnp.sum(jnp.square(params["b"] - batch["tb"]))
                  + jnp.sum(jnp.square(2.0 * params["w"]["k"]
                                       - batch["tw"])))


def _torch_loss(params, batch):
    return 0.5 * (torch.sum(torch.square(params["b"] - batch["tb"]))
                  + torch.sum(torch.square(2.0 * params["w"]["k"]
                                           - batch["tw"])))


def _ref_grad_fn(params, batch, key):
    del key
    return jax.value_and_grad(_jax_loss)(params, batch)


def _ref_spec():
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    return ref_flat.make_flat_spec(shapes)


def _ref_opt(name):
    return {"sgd": None, "momentum": ref_optim.momentum_sgd(),
            "adamw": ref_optim.adamw()}[name]


def _port_opt(name):
    return {"sgd": None, "momentum": optim.momentum_sgd(),
            "adamw": optim.adamw()}[name]


def _batches(seed: int, lead: tuple):
    rng = np.random.default_rng(seed)
    return [{"tb": rng.standard_normal(lead + (37,)).astype(np.float32),
             "tw": rng.standard_normal(lead + (3, 61)).astype(np.float32)}
            for _ in range(ROUNDS)]


def _keys_at(key, t):
    return jax.random.split(jax.random.fold_in(key, t), 3)


def _draw_tables(run_keys, p_fail, codec, d):
    """The reference's draws of steps 1..H·ROUNDS for each run key: its
    link uniforms, participants and int8 noise (the flat engine's
    ``split(fold_in(key, t), 3)``, repro/core/flat.py:441-451)."""
    links, parts, noise = {}, {}, {}
    for t in range(1, H * ROUNDS + 1):
        ks = [_keys_at(k, t) for k in run_keys]
        parts[t] = np.stack([np.asarray(jax.random.randint(
            kk[2], (K,), 0, N)) for kk in ks]).astype(np.int64)
        if p_fail > 0:
            links[t] = np.stack([np.asarray(jax.random.uniform(
                kk[0], (N, N))) for kk in ks])
        if codec == "int8":
            noise[t] = np.stack([np.asarray(ref_codec_noise(kk[0], N, d))
                                 for kk in ks])
    return links, parts, noise


def _ref_state(cls, flat0, opt_name, codec, impl):
    ref_opt = _ref_opt(opt_name)
    x = jnp.asarray(flat0)
    init = None if ref_opt is None else ref_opt.init if x.ndim == 2 \
        else jax.vmap(ref_opt.init)
    residual = () if codec == "none" or impl == "none" \
        else jnp.zeros_like(x)
    step = jnp.asarray(1, jnp.int32) if x.ndim == 2 \
        else jnp.ones(x.shape[0], jnp.int32)
    return cls(flat=x, step=step,
               opt_state=() if ref_opt is None else init(x),
               residual=residual)


def _ref_cfg(graph, p_fail, impl, codec, server, h=H):
    return RefFedDecConfig(mixing=RefMixing(graph, p_fail=p_fail,
                                            scheme="metropolis"),
                           h=h, k=K, gossip_impl=impl, gossip_compress=codec,
                           server_enabled=server)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_inputs(name):
    """Flat case ``name``'s inputs: its configuration, start, batches and
    the reference's draws (keyed by step) as numpy."""
    kind, p_fail, impl, codec, opt, server, executor = CASES[name]
    ref_g, _ = _graph_pair(kind, N)
    rng = np.random.default_rng(len(name))
    flat0 = rng.standard_normal((N, _ref_spec().d)).astype(np.float32)
    links, parts, noise = _draw_tables([jax.random.key(11)], p_fail, codec,
                                       flat0.shape[1])
    return {"kind": "flat", "adjacency": np.asarray(ref_g.adjacency),
            "p_fail": p_fail, "impl": impl, "codec": codec, "opt": opt,
            "server": server, "executor": executor, "flat0": flat0,
            "batches": _batches(len(name) + 1, (H, N)),
            "links": {t: v[0] for t, v in links.items()},
            "parts": {t: v[0] for t, v in parts.items()},
            "noise": {t: v[0] for t, v in noise.items()}}


def _sweep_inputs(name):
    runs, p_fail, codec, opt, per_run = SWEEP_CASES[name]
    graphs = [np.asarray(_graph_pair(kind, N, seed)[0].adjacency)
              for kind, seed, _, _ in runs]
    rng = np.random.default_rng(len(name))
    flat0 = rng.standard_normal((len(runs), N, _ref_spec().d)).astype(
        np.float32)
    key = jax.random.key(13)
    run_keys = [jax.random.fold_in(key, r) if per_run else key
                for r in range(len(runs))]
    links, parts, noise = _draw_tables(run_keys, p_fail, codec,
                                       flat0.shape[2])
    return {"kind": "sweep", "runs": [(g, h, impl) for g, (_, _, h, impl)
                                      in zip(graphs, runs)],
            "p_fail": p_fail, "codec": codec, "opt": opt, "flat0": flat0,
            "batches": _batches(len(name) + 1, (H, len(runs), N)),
            "links": links, "parts": parts, "noise": noise,
            "run_keys": run_keys}


def _want(state, losses):
    return {"flat": np.asarray(state.flat),
            "opt": _np_tree(state.opt_state),
            "res": _np_tree(state.residual), "losses": losses}


def _ref_flat_run(name, mesh=None):
    """The reference's flat round on flat case ``name`` (its sharded round
    on ``mesh``): the final state and the losses as numpy."""
    case = _inputs(name)
    rcfg = _ref_cfg(ref_topo.Graph(case["adjacency"]), case["p_fail"],
                    case["impl"], case["codec"], case["server"])
    spec, opt = _ref_spec(), _ref_opt(case["opt"])
    lr = lambda t: jnp.asarray(ETA, jnp.float32)  # noqa: E731
    state = _ref_state(ref_flat.FlatFedState, case["flat0"], case["opt"],
                       case["codec"], case["impl"])
    if mesh is None:
        round_ref = ref_flat.make_flat_feddec_round(
            rcfg, spec, _ref_grad_fn, lr, optimizer=opt, donate=False)
    else:
        state = ref_sharded.shard_flat_state(state, mesh)
        round_ref = ref_sharded.make_sharded_feddec_round(
            rcfg, spec, _ref_grad_fn, lr, mesh, optimizer=opt, donate=False)
    losses = []
    for b in case["batches"]:
        state, met = round_ref(state, jax.tree.map(jnp.asarray, b),
                               jax.random.key(11))
        losses.extend(np.asarray(met["loss"]).tolist())
    return _want(state, losses)


def _ref_sweep_run(name):
    case = _inputs(name)
    plan = ref_sweep.make_sweep_plan([
        _ref_cfg(ref_topo.Graph(adj), case["p_fail"], impl, case["codec"],
                 True, h) for adj, h, impl in case["runs"]])
    state = _ref_state(ref_sweep.SweepFedState, case["flat0"], case["opt"],
                       case["codec"], plan.gossip_impl)
    round_ref = ref_sweep.make_sweep_feddec_round(
        plan, _ref_spec(), _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32),
        optimizer=_ref_opt(case["opt"]), donate=False)
    keys = jnp.stack(case["run_keys"])
    losses = []
    for b in case["batches"]:
        state, met = round_ref(state, jax.tree.map(jnp.asarray, b), keys)
        losses.extend(np.asarray(met["loss"]).tolist())
    return _want(state, losses)


_INPUTS: dict = {}
_WANT: dict = {}


def _inputs(name):
    if name not in _INPUTS:
        _INPUTS[name] = _flat_inputs(name) if name in CASES \
            else _sweep_inputs(name)
    return _INPUTS[name]


def _ref_want(name):
    """The reference's result of case ``name`` (its flat engine, its
    sweep engine for a lattice), computed once."""
    if name not in _WANT:
        _WANT[name] = _ref_flat_run(name) if name in CASES \
            else _ref_sweep_run(name)
    return _WANT[name]


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


class TableDraws:
    """Draws served from tables keyed by the step t (a lattice's counters
    move together here, so its first entry keys them)."""

    def __init__(self, case):
        self.case = case

    @staticmethod
    def _t(t):
        return int(np.asarray(t).reshape(-1)[0])

    def link_uniforms(self, t, n):
        return torch.from_numpy(self.case["links"][self._t(t)])

    def participants(self, t, n, k):
        return torch.from_numpy(self.case["parts"][self._t(t)])

    def codec_noise(self, t, n, d, leaf=None):
        return torch.from_numpy(self.case["noise"][self._t(t)])


def _port_spec():
    return flat_lib.make_flat_spec({"b": torch.zeros(37),
                                    "w": {"k": torch.zeros(3, 61)}})


def _port_cfg(adjacency, p_fail, impl, codec, server=True, h=H):
    return FedDecConfig(mixing=MixingDistribution(
        topo.Graph(adjacency), p_fail=p_fail, scheme="metropolis"),
        h=h, k=K, gossip_impl=impl, gossip_compress=codec,
        server_enabled=server)


def _port_state(cls, flat0, opt, codec, impl):
    x = torch.from_numpy(flat0.copy())
    residual = () if codec == "none" or impl == "none" \
        else torch.zeros_like(x)
    opt_state = ()
    if opt is not None:
        opt_state = opt.init(x) if x.ndim == 2 else tree_map(
            torch.Tensor.contiguous, torch.func.vmap(opt.init)(x))
    step = 1 if x.ndim == 2 else np.ones(x.shape[0], np.int64)
    return cls(flat=x, step=step, opt_state=opt_state, residual=residual)


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _run_port_case(case, mesh):
    """This rank's run of ``case`` on the sharded engine; the gathered
    (whole) final state and the losses."""
    spec = _port_spec()
    eta = torch.tensor([ETA])
    opt = _port_opt(case["opt"])
    draws = TableDraws(case)
    if case["kind"] == "flat":
        cfg = _port_cfg(case["adjacency"], case["p_fail"], case["impl"],
                        case["codec"], case["server"])
        state = sharded.shard_flat_state(_port_state(
            flat_lib.FlatFedState, case["flat0"], opt, case["codec"],
            case["impl"]), mesh)
        make = sharded.make_sharded_feddec_round \
            if case["executor"] == "round" \
            else sharded.make_sharded_feddec_step
        fn = make(cfg, spec, engine.value_and_grad(_torch_loss),
                  lambda t: eta, mesh, device="cpu", optimizer=opt)
        rows = slice(state.flat.shape[0] * mesh.get_local_rank("agents"),
                     state.flat.shape[0] * (mesh.get_local_rank("agents")
                                            + 1))
        losses = []
        for b in case["batches"]:
            blk = {k: torch.from_numpy(v[:, rows].copy())
                   for k, v in b.items()}
            if case["executor"] == "round":
                state, met = fn(state, blk, draws)
                losses.extend(met["loss"].tolist())
            else:
                for h in range(H):
                    state, met = fn(state, {k: v[h] for k, v in blk.items()},
                                    draws)
                    losses.append(float(met["loss"]))
        whole = sharded.gather_flat_state(state, mesh)
    else:
        configs = [_port_cfg(adj, case["p_fail"], impl, case["codec"], True,
                             h) for adj, h, impl in case["runs"]]
        plan = sweep.make_sweep_plan(configs)
        state = sharded.shard_sweep_state(_port_state(
            sweep.SweepFedState, case["flat0"], opt, case["codec"],
            plan.gossip_impl), mesh)
        round_fn = engine.make_sharded_sweep_round(
            plan, spec, engine.value_and_grad(_torch_loss), lambda t: eta,
            mesh, device="cpu", optimizer=opt)
        n_local = state.flat.shape[1]
        me = mesh.get_local_rank("agents")
        rows = slice(me * n_local, (me + 1) * n_local)
        losses = []
        for b in case["batches"]:
            blk = {k: torch.from_numpy(v[:, :, rows].copy())
                   for k, v in b.items()}
            state, met = round_fn(state, blk, draws)
            losses.extend(met["loss"].tolist())
        whole = sharded.gather_sweep_state(state, mesh)
    return {"flat": whole.flat.numpy(), "opt": _tree_numpy(whole.opt_state),
            "res": _tree_numpy(whole.residual), "losses": losses,
            "step": np.asarray(whole.step).tolist()}


def _permute_inputs(world: int):
    """The permute gossip's inputs of a world: a ring of ``world`` agents,
    a random W and a stacked tree of two leaves, one agent a rank."""
    rng = np.random.default_rng(world)
    adj = np.asarray(ref_topo.ring_graph(world, k=1).adjacency)
    w = rng.uniform(size=(world, world)).astype(np.float32)
    stacked = {"a": rng.standard_normal((world, 3, 5)).astype(np.float32),
               "b": rng.standard_normal((world, 7)).astype(np.float32)}
    return adj, w, stacked


def _run_permute(mesh, world: int) -> dict:
    """This rank's gossip.make_permute_gossip mix, plain and over a bf16
    wire, gathered to the whole (world, ...) leaves."""
    import torch.distributed as dist

    from repro_torch.core import gossip
    adj, w, stacked = _permute_inputs(world)
    me = mesh.get_local_rank("agents")
    mine = {k: torch.from_numpy(v[me:me + 1].copy())
            for k, v in stacked.items()}
    out = {}
    for wire in (None, torch.bfloat16):
        fn = gossip.make_permute_gossip(topo.Graph(adj), mesh, "agents",
                                        exchange_dtype=wire)
        y = fn(torch.from_numpy(w), mine)
        whole = {}
        for k, leaf in y.items():
            buf = torch.empty((world,) + tuple(leaf.shape[1:]))
            dist.all_gather_into_tensor(buf, leaf.contiguous(),
                                        group=mesh.get_group("agents"))
            whole[k] = buf.numpy()
        out["bf16" if wire is not None else "f32"] = whole
    return out


def _world_main(rank, world, store_path, cases_path, out_path):
    """One rank of a spawned gloo world: every case, rank 0 writes the
    gathered results."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_agent_mesh(world, device="cpu")
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {name: _run_port_case(case, mesh)
                   for name, case in cases.items()}
        results["permute"] = _run_permute(mesh, world)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _port_inputs(name):
    """Case ``name``'s inputs as the ranks take them (numpy only)."""
    return {k: v for k, v in _inputs(name).items() if k != "run_keys"}


def _start_world(tmp_path, world: int, names):
    """Spawn a gloo world of ``world`` ranks running every case of
    ``names``; returns (its process context, where rank 0 writes)."""
    import torch.multiprocessing as mp
    cases_path, out_path = tmp_path / "cases.pkl", tmp_path / "out.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump({n: _port_inputs(n) for n in names}, f)
    ctx = mp.start_processes(
        _world_main, args=(world, str(tmp_path / "store"), str(cases_path),
                           str(out_path)),
        nprocs=world, start_method="spawn", join=False)
    return ctx, out_path


REF_SHARDED_CASE = "geo-sparse-int8-momentum"


def _ref_sharded_main(out_path):
    """The reference's own sharded round on REF_SHARDED_CASE: run in a
    subprocess with 4 forced host devices."""
    from repro.launch.mesh import make_agent_mesh as ref_make_agent_mesh
    from repro.core import gossip as ref_gossip
    mesh = ref_make_agent_mesh(4)
    want = _ref_flat_run(REF_SHARDED_CASE, mesh=mesh)
    adj, w, stacked = _permute_inputs(4)
    want["permute"] = {
        "bf16" if wire is not None else "f32": _np_tree(
            ref_gossip.make_permute_gossip(
                ref_topo.Graph(adj), mesh, "agents", exchange_dtype=wire)(
                jnp.asarray(w), jax.tree.map(jnp.asarray, stacked)))
        for wire in (None, jnp.bfloat16)}
    with open(out_path, "wb") as f:
        pickle.dump(want, f)


# the CLI's run under torchrun (the flat run is made in the test)
CLI = ["--device", "cpu", "--steps", "10", "--agents", "4", "--batch", "1",
       "--seq", "8", "--d-model", "64", "--layers", "1", "--vocab", "64",
       "--h", "5", "--lr", "0.5", "--gossip-impl", "sparse",
       "--gossip-compress", "identity"]


def _losses(line: str) -> list:
    """The losses of a [train] line: its numbers of four decimals."""
    return [float(w) for w in re.findall(r"\d+\.\d{4}(?!\d)", line)]


ALL = list(CASES) + list(SWEEP_CASES)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The gathered results of every case in a 2-rank and a 4-rank world,
    and the reference's own 4-device sharded round: both worlds and that
    subprocess run while this process computes the reference's results."""
    tmp = tmp_path_factory.mktemp("worlds")
    started = {}
    for w in (2, 4):
        (tmp / str(w)).mkdir()
        started[w] = _start_world(tmp / str(w), w, ALL)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    ref_out = tmp / "ref_sharded.pkl"
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_sharded as m; "
         "m._ref_sharded_main(sys.argv[1])", str(ref_out)], env=env)
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--mesh-agents", "2"], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name in ALL:
        _ref_want(name)
    out = {}
    for w, (ctx, out_path) in started.items():
        while not ctx.join():
            pass
        with open(out_path, "rb") as f:
            out[w] = pickle.load(f)
    assert ref_proc.wait(timeout=240) == 0
    with open(ref_out, "rb") as f:
        out["ref_sharded"] = pickle.load(f)
    stdout, stderr = cli_proc.communicate(timeout=240)
    out["cli"] = (cli_proc.returncode, stdout, stderr)
    return out


def _assert_close(got, want, what, scale=None):
    """Within TOL·``scale`` (default: max|want|); integer leaves exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}.{k}", scale)
        return
    if isinstance(want, tuple) and want == ():
        assert got == (), what
        return
    want = np.asarray(want)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)
        return
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL}·{scale:.3e}"


def _u_bound(codec: str, want: dict) -> float:
    """One rounding step of ``codec`` at the largest |u| = |x + e| of the
    reference's final state (tests/test_torch_compress.py's rule)."""
    u = np.abs(want["flat"] + want["res"])
    if codec == "int8":
        return 2.0 * float(u.max()) / 127.0
    if codec == "bf16":
        return float(2.0 ** (np.floor(np.log2(u.max())) - 7))
    k = max(1, min(u.shape[-1], int(round(float(codec[5:]) * u.shape[-1]))))
    return float(np.sort(u, axis=-1)[..., -k].max())


def _assert_state(got, want, codec="none"):
    """Uncompressed and identity: the buffer, the optimizer state and the
    residual within TOL·max|x|, the losses within TOL relative.  A lossy
    codec (int8, top-k, bf16) is held as tests/test_torch_compress.py
    holds the flat engine's lossy cells: two summation orders may round a
    borderline element of u to either side (the port's own flat engine
    does so against the reference's on these cases), so the losses within
    1e-4 relative, at least 99% of the elements of x and of the residual
    within TOL·max|x|, and every element within one rounding step."""
    scale = float(np.abs(want["flat"]).max())
    if codec in ("none", "identity"):
        _assert_close(got["flat"], want["flat"], "flat", scale)
        _assert_close(got["opt"], want["opt"], "opt_state", scale)
        _assert_close(got["res"], want["res"], "residual", scale)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        return
    bound = _u_bound(codec, want)
    for key in ("flat", "res"):
        err = np.abs(np.asarray(got[key], np.float64) - want[key])
        assert (err <= TOL * scale).mean() >= 0.99, \
            f"{key}: {(err > TOL * scale).mean():.3%} of elements beyond " \
            f"{TOL}·max|x|"
        assert err.max() <= bound, f"{key}: {err.max():.3e} > {bound:.3e}"
    assert np.abs(want["res"]).max() > 0   # the lossy codec left a residual
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def _codec(name: str) -> str:
    return CASES[name][3] if name in CASES else SWEEP_CASES[name][2]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ALL)
def test_sharded_engine_matches_reference(worlds, world, name):
    got, want = worlds[world][name], _ref_want(name)
    _assert_state(got, want, _codec(name))


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield mesh_lib.make_agent_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["ring-pallas-sgd", "ring-pfail-pallas-int8",
                                  "sweep-seed-pfail-pallas",
                                  "geo-dense-momentum-step"])
def test_world_of_one_lowers_the_sharded_engine(world_of_one, name):
    """A mesh of one shard lowers the sharded engine (the reference's
    dispatch): no collective, the same trajectory."""
    mesh = world_of_one
    espec = engine.parse_engine_spec(
        _port_cfg(np.asarray(ref_topo.ring_graph(N, 2).adjacency), 0.0,
                  "pallas", "none"))
    assert engine._dispatch(espec, _port_spec(), mesh) == "sharded"
    got, want = _run_port_case(_port_inputs(name), mesh), _ref_want(name)
    _assert_state(got, want, _codec(name))


def test_engine_refuses_what_the_sharded_lowering_does_not_take(
        world_of_one):
    """The reference's checks of the sharded lowering; a 2-D spec on a
    mesh without a model dim fails with the reference's message."""
    mesh = world_of_one
    cfg = _port_cfg(np.asarray(ref_topo.ring_graph(N, 2).adjacency), 0.0,
                    "pallas", "none")
    spec, gfn = _port_spec(), engine.value_and_grad(_torch_loss)
    espec = engine.parse_engine_spec(cfg)
    with pytest.raises(ValueError, match="metrics_fn is not supported"):
        engine.make_engine_round(espec, gfn, None, device="cpu",
                                 flat_spec=spec, mesh=mesh,
                                 metrics_fn=lambda s: {})
    with pytest.raises(ValueError, match="single-device"):
        engine.parse_engine_spec(cfg, n_shards=2, fuse_update_mix=True)
    with pytest.raises(ValueError, match="mesh has no model axis 'model'"):
        sharded.make_sharded_feddec_round(cfg, spec, gfn, None, mesh,
                                          device="cpu", model_axis="model")
    with pytest.raises(ValueError, match="mesh has no model axis 'model'"):
        engine.make_engine_step(engine.parse_engine_spec(
            cfg, n_model_shards=2), gfn, None, device="cpu", flat_spec=spec,
            mesh=mesh)
    with pytest.raises(ValueError, match="mesh has no axis 'rows'"):
        sharded.make_sharded_gossip(cfg, mesh, axis_name="rows")


def test_port_world_of_four_matches_the_reference_sharded_round(worlds):
    """The reference's own make_sharded_feddec_round on 4 forced host
    devices (a subprocess) and the port's 4-rank world, on one case."""
    _assert_state(worlds[4][REF_SHARDED_CASE], worlds["ref_sharded"],
                  _codec(REF_SHARDED_CASE))


def test_cli_mesh_agents_prints_the_flat_run(worlds, capsys):
    """--mesh-agents 2 --device cpu under torchrun (two gloo ranks, the
    sparse halo; started by the module's fixture) prints the flat run's
    header (with the sharding named), its step-10 loss and its done line,
    within the 4 printed decimals."""
    from repro_torch.launch import train as port_train
    rc, stdout, stderr = worlds["cli"]
    assert rc == 0, stderr[-2000:]
    sharded_out = [ln for ln in stdout.splitlines()
                   if ln.startswith("[train]")]
    port_train.main(CLI)
    flat_out = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[train]")]
    assert len(sharded_out) == len(flat_out) == 3    # rank 0 alone prints
    assert sharded_out[0] == flat_out[0].replace(
        "layout=flat", "layout=flat (sharded over 2 devices)")
    for got, want in zip(sharded_out[1:], flat_out[1:]):
        assert got.split("loss")[0] == want.split("loss")[0]
        assert len(_losses(got)) == len(_losses(want)) > 0
        np.testing.assert_allclose(_losses(got), _losses(want), atol=1.5e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_permute_gossip_matches_reference(worlds, world):
    """gossip.make_permute_gossip, one agent a rank on a ring: y_i =
    W_ii x_i + Σ_j W_ij x_j over the neighbours, summed in f32, the wire
    plain or bf16 (the neighbours' rows rounded to bf16).  Held to that
    sum here, and in the 4-rank world to the reference's own
    make_permute_gossip on 4 host devices, within 1e-6·max|y|."""
    adj, w, stacked = _permute_inputs(world)
    got = worlds[world]["permute"]
    for wire, cast in (("f32", lambda a: a),
                       ("bf16", lambda a: np.asarray(
                           torch.from_numpy(a).bfloat16().float()))):
        for k, x in stacked.items():
            rows = x.reshape(world, -1)
            nb = (w * adj) @ cast(rows).astype(np.float64)
            want = (np.diag(w)[:, None] * rows + nb).reshape(x.shape)
            scale = np.abs(want).max()
            assert np.abs(got[wire][k] - want).max() <= 1e-6 * scale
            if world == 4:
                ref = worlds["ref_sharded"]["permute"][wire][k]
                assert np.abs(got[wire][k] - ref).max() <= 1e-6 * scale
