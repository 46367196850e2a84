"""The port's 2-D ('agents', 'model') mesh (launch/mesh.make_fed_mesh, the
column-sharded flat engine of core/sharded.py, ``--mesh-model``, the
collective-axis classifier of launch/trace_analysis.py and the dry run's
2-D records) against the JAX package.

The reference's own 2-D tests hold its engine to the single-device flat
round (tests/test_mesh.py:339-382, tests/conformance/test_grid.py:
353-386); this file holds the port's to the same oracle:

* One spawned gloo world of 4 ranks (started once for the module by a
  fixture, while this process computes the reference's results) builds
  the meshes (4, 1), (2, 2) and (1, 4) in turn and runs:

  - the reference's 2-D grid (tests/conformance/test_grid.py:372-379) on
    its problem (linreg, n 8, d 24, H 4, T 6, conformance/_equiv.py's
    config): dense, sparse, pallas, none, sparse + int8 + p_fail 0.3,
    dense + adamw, each held to the reference's ``make_flat_feddec_round``
    under its replayed draws within 1e-5·max|x| (int8 by
    tests/test_torch_sharded.py's criterion), each rank's x, optimizer
    and residual blocks exactly n/A · D/M · 4 bytes;
  - the matrix cell of tests/test_mesh.py:339-382 at (2, 2): N 16, D
    256, H 2, ring k=2, Metropolis, dense and sparse, state and losses
    within 1e-5, then one step under ``trace_analysis.tally`` on every
    rank, classified by ``axis_separation``: no 'mixed' or 'unknown', the
    gossip kinds on 'agents' only, 'model' carrying only the line-4
    all-gather (and, under int8, the scale's all-reduce);
  - the mesh contracts of tests/test_mesh.py:28-80 that need a group:
    names, shape, the rank order ``arange(A·M).reshape(A, M)``, (A, 1)
    covering the agent mesh's ranks in order, a wrong world refused.

* In this process: the port's group and pair classifiers against the
  reference's (tests/test_mesh.py:196-235), the ``model_axis_conflict``
  cases of tests/conformance/test_model_axis_errors.py with the
  reference's exact messages (the spec, the makers, train_loop and the
  CLI), ``--mesh-agents 2 --mesh-model 2 --device cpu`` under torchrun
  (started by the fixture) printing the flat run's lines, and a sharded
  ``--mesh-model 2`` dry-run record of the tiny LM whose ``mesh2d`` block
  equals the reference's ``mesh2d_cost_model``.

The spawned ranks import this module: its module level imports no jax.
"""

from __future__ import annotations

import os
import pickle
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.core import engine, flat as flat_lib, sharded
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import trace_analysis
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFORMANCE = os.path.join(ROOT, "tests", "conformance")
MESHES = ((4, 1), (2, 2), (1, 4))
TOL = 1e-5
# the conformance problem of tests/conformance/_equiv.py, at d 24 (the 2-D
# engine needs D divisible by M)
N, D, H_CFG, T_RUN, K = 8, 24, 4, 6, 2
KEY_SEED, BATCH_SEED = 5, 11
# tests/conformance/test_grid.py:372-379: (config keywords, optimizer)
GRID = {
    "dense": (dict(gossip_impl="dense"), None),
    "sparse": (dict(gossip_impl="sparse"), None),
    "pallas": (dict(gossip_impl="pallas"), None),
    "none": (dict(gossip_impl="none"), None),
    "sparse-int8-pfail": (dict(gossip_impl="sparse", codec="int8",
                               p_fail=0.3), None),
    "dense-adamw": (dict(gossip_impl="dense"), "adamw"),
}
# the matrix cell of tests/test_mesh.py:339-382, at (2, 2)
MX_N, MX_D, MX_H, MX_A, MX_M = 16, 256, 2, 2, 2
MX_IMPLS = ("dense", "sparse")
# the tallied step's cells: (impl, codec)
TALLY = (("dense", "none"), ("sparse", "none"), ("dense", "int8"))
GOSSIP_KINDS = ("collective-permute", "reduce-scatter", "all-to-all")
# the CLI's 2-D run under torchrun (the flat run is made in the test)
CLI = ["--device", "cpu", "--steps", "10", "--agents", "4", "--batch", "1",
       "--seq", "8", "--d-model", "64", "--layers", "1", "--vocab", "64",
       "--h", "5", "--lr", "0.5", "--gossip-impl", "sparse",
       "--gossip-compress", "identity"]


# ---------------------------------------------------------------------------
# The reference's side (this process)
# ---------------------------------------------------------------------------


def _ref_problem():
    from repro.data import linreg as ref_linreg
    return ref_linreg.make_problem(n=N, d=D, seed=0, c_base=1.3)


def _equiv():
    """tests/conformance/_equiv.py, the reference's conformance cell."""
    if CONFORMANCE not in sys.path:
        sys.path.insert(0, CONFORMANCE)
    import _equiv
    return _equiv


def _draw_tables(key, t_steps: int, n: int, d: int, p_fail: float,
                 codec: str, k: int) -> dict:
    """The reference flat engine's draws of steps 1..t_steps from ``key``
    (``split(fold_in(key, t), 3)``): link uniforms, participants, int8
    noise, as numpy keyed by t."""
    import jax
    from test_torch_engine import ref_codec_noise
    links, parts, noise = {}, {}, {}
    for t in range(1, t_steps + 1):
        kk = jax.random.split(jax.random.fold_in(key, t), 3)
        parts[t] = np.asarray(jax.random.randint(kk[2], (k,), 0, n),
                              np.int64)
        if p_fail > 0:
            links[t] = np.asarray(jax.random.uniform(kk[0], (n, n)))
        if codec == "int8":
            noise[t] = np.asarray(ref_codec_noise(kk[0], n, d))
    return {"links": links, "parts": parts, "noise": noise}


def _want(state, metrics) -> dict:
    import jax
    return {"flat": np.asarray(state.flat),
            "opt": jax.tree.map(np.asarray, state.opt_state),
            "res": jax.tree.map(np.asarray, state.residual),
            "losses": np.asarray(metrics["loss"]).tolist()}


def _grid_setup():
    """The grid's shared pieces: the reference's conformance module, flat
    spec, grad and lr functions, batches and key
    (tests/conformance/_equiv.py)."""
    import jax
    import jax.numpy as jnp
    from repro.core import flat as ref_flat
    eq = _equiv()
    prob = _ref_problem()
    return (eq, ref_flat.make_flat_spec(jnp.zeros(D)), eq.grad_fn(prob),
            eq.lr_fn(prob), eq.stacked_batches(prob=prob),
            jax.random.key(KEY_SEED))


def _grid_inputs() -> dict:
    """Every grid cell's inputs for the ranks (numpy only), keyed by cell
    name: its graph and codec, the batches, η per step and the
    reference's draws."""
    import jax.numpy as jnp
    eq, _, _, lfn, (xb, yb), key = _grid_setup()
    eta = {t: float(np.asarray(lfn(jnp.asarray(t, jnp.int32)), np.float32))
           for t in range(1, T_RUN + 1)}
    cases = {}
    for name, (kw, opt_name) in GRID.items():
        cfg = eq.make_cfg(**kw)
        cases[name] = {
            "adjacency": np.asarray(cfg.mixing.graph.adjacency),
            "scheme": cfg.mixing.scheme, "p_fail": cfg.mixing.p_fail,
            "impl": cfg.gossip_impl, "codec": cfg.gossip_compress,
            "opt": opt_name, "x": np.asarray(xb), "y": np.asarray(yb),
            "eta": eta, **_draw_tables(key, T_RUN, N, D, cfg.mixing.p_fail,
                                       cfg.gossip_compress, K)}
    return cases


def _grid_wants() -> dict:
    """The reference's flat round on every grid cell, keyed by name."""
    import jax.numpy as jnp
    from repro.core import flat as ref_flat
    eq, spec, gfn, lfn, batches, key = _grid_setup()
    wants = {}
    for name, (kw, opt_name) in GRID.items():
        cfg = eq.make_cfg(**kw)
        opt = eq.make_optimizer(opt_name)
        st = ref_flat.init_flat_state(spec, jnp.zeros(D), N, optimizer=opt,
                                      compress=eq.init_compress(cfg))
        rnd = ref_flat.make_flat_feddec_round(cfg, spec, gfn, lfn,
                                              optimizer=opt, donate=False)
        wants[name] = _want(*rnd(st, batches, key))
    return wants


def _mx_setup():
    """The matrix cell's ring, batches and key (tests/test_mesh.py:
    339-357)."""
    import jax
    import jax.numpy as jnp
    from repro.core import topology as ref_topo
    batches = jax.random.normal(jax.random.key(3), (MX_H, MX_N, MX_D),
                                jnp.float32)
    return ref_topo.ring_graph(MX_N, k=2), batches, jax.random.key(4)


def _mx_inputs() -> dict:
    """The matrix cell's inputs for the ranks, with the reference's
    draws (int8 noise for the tallied int8 step)."""
    graph, batches, key = _mx_setup()
    return {"adjacency": np.asarray(graph.adjacency),
            "batches": np.asarray(batches),
            **_draw_tables(key, MX_H, MX_N, MX_D, 0.0, "int8", 2)}


def _mx_wants() -> dict:
    """The matrix cell's reference: its flat round, dense and sparse."""
    import jax.numpy as jnp
    from repro.core import FedDecConfig as RefFedDecConfig
    from repro.core import flat as ref_flat
    from repro.core.mixing import MixingDistribution as RefMixing
    graph, batches, key = _mx_setup()
    md = RefMixing(graph, scheme="metropolis")
    spec = ref_flat.make_flat_spec(jnp.zeros(MX_D))

    def grad_fn(p, batch, key):
        del key
        return 0.5 * jnp.sum((p - batch) ** 2), p - batch

    lr = lambda t: jnp.asarray(0.05, jnp.float32)  # noqa: E731
    wants = {}
    for impl in MX_IMPLS:
        cfg = RefFedDecConfig(mixing=md, h=MX_H, k=2, gossip_impl=impl)
        rnd = ref_flat.make_flat_feddec_round(cfg, spec, grad_fn, lr,
                                              donate=False)
        wants[impl] = _want(*rnd(ref_flat.init_flat_state(
            spec, jnp.zeros(MX_D), MX_N), batches, key))
    return wants


# ---------------------------------------------------------------------------
# The port's side: runs in every rank (no jax in what it calls)
# ---------------------------------------------------------------------------


class TableDraws:
    """The reference's draws, served from tables keyed by the step t."""

    def __init__(self, case):
        self.case = case

    def link_uniforms(self, t, n):
        return torch.from_numpy(self.case["links"][int(t)])

    def participants(self, t, n, k):
        return torch.from_numpy(self.case["parts"][int(t)])

    def codec_noise(self, t, n, d, leaf=None):
        return torch.from_numpy(self.case["noise"][int(t)])


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _block_bytes(state) -> list:
    """Bytes of each (rows, cols) block of a state: its storage's, and
    its elements'."""
    out = []
    for t in [state.flat, *_leaves(state.opt_state),
              *_leaves(state.residual)]:
        if isinstance(t, torch.Tensor) and t.ndim == 2:
            out.append((t.untyped_storage().nbytes(),
                        t.numel() * t.element_size()))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _run_grid_cell(case, mesh) -> dict:
    """This rank's run of one grid cell on ``mesh`` (the 2-D engine):
    the gathered end state, the losses and this rank's block bytes."""
    cfg = FedDecConfig(mixing=MixingDistribution(
        topo.Graph(case["adjacency"]), p_fail=case["p_fail"],
        scheme=case["scheme"]), h=H_CFG, k=K, gossip_impl=case["impl"],
        gossip_compress=case["codec"])
    opt = {None: None, "adamw": optim.adamw(weight_decay=0.0)}[case["opt"]]
    spec = flat_lib.make_flat_spec({"z": torch.zeros(D)})
    codec = case["codec"] if case["impl"] != "none" else "none"
    state = sharded.shard_flat_state(flat_lib.init_flat_state(
        spec, {"z": torch.zeros(D)}, N, optimizer=opt, compress=codec),
        mesh, model_axis="model")
    etas = {t: torch.tensor([v]) for t, v in case["eta"].items()}
    rnd = sharded.make_sharded_feddec_round(
        cfg, spec, linreg.make_grad_fn(1), lambda t: etas[int(t)], mesh,
        device="cpu", optimizer=opt, model_axis="model")
    n_local = N // mesh.mesh.shape[0]
    rows = slice(mesh.get_local_rank("agents") * n_local,
                 (mesh.get_local_rank("agents") + 1) * n_local)
    state, met = rnd(state, {"x": torch.from_numpy(case["x"][:, rows]),
                             "y": torch.from_numpy(case["y"][:, rows])},
                     TableDraws(case))
    nbytes = _block_bytes(state)
    whole = sharded.gather_flat_state(state, mesh, model_axis="model")
    return {"flat": whole.flat.numpy(), "opt": _tree_numpy(whole.opt_state),
            "res": _tree_numpy(whole.residual),
            "losses": met["loss"].tolist(), "bytes": nbytes}


def _mx_cfg(case, impl, codec="none"):
    return FedDecConfig(mixing=MixingDistribution(
        topo.Graph(case["adjacency"]), scheme="metropolis"), h=MX_H, k=2,
        gossip_impl=impl, gossip_compress=codec)


def _mx_grad(p, batch):
    r = p["z"] - batch["t"]
    return 0.5 * torch.sum(r * r), {"z": r}


def _run_matrix(case, mesh) -> dict:
    """The matrix cell at (2, 2): each impl's round (gathered) and each
    TALLY cell's one step under the tally, classified on this rank."""
    spec = flat_lib.make_flat_spec({"z": torch.zeros(MX_D)})
    eta = torch.tensor([0.05])
    n_local = MX_N // MX_A
    a = mesh.get_local_rank("agents")
    batches = torch.from_numpy(case["batches"][:, a * n_local:
                                               (a + 1) * n_local])
    out = {}
    for impl in MX_IMPLS:
        state = sharded.shard_flat_state(flat_lib.init_flat_state(
            spec, {"z": torch.zeros(MX_D)}, MX_N), mesh, model_axis="model")
        rnd = sharded.make_sharded_feddec_round(
            _mx_cfg(case, impl), spec, _mx_grad, lambda t: eta, mesh,
            device="cpu", model_axis="model")
        state, met = rnd(state, {"t": batches}, TableDraws(case))
        out[impl] = {"flat": sharded.gather_flat_state(
            state, mesh, model_axis="model").flat.numpy(),
            "losses": met["loss"].tolist(), "bytes": _block_bytes(state)}
    for impl, codec in TALLY:
        state = sharded.shard_flat_state(flat_lib.init_flat_state(
            spec, {"z": torch.zeros(MX_D)}, MX_N, compress=codec), mesh,
            model_axis="model")
        step = sharded.make_sharded_feddec_step(
            _mx_cfg(case, impl, codec), spec, _mx_grad, lambda t: eta, mesh,
            device="cpu", model_axis="model")
        # step 1 of H 2 does not fire the server: step 2 does
        _, costs = trace_analysis.tally(lambda: [step(
            state, {"t": batches[h]}, TableDraws(case))
            for h in range(MX_H)])
        out[f"tally-{impl}-{codec}"] = {
            "sep": trace_analysis.axis_separation(costs, MX_A, MX_M),
            "axes": [(c.kind, c.axis) for c in
                     trace_analysis.collective_axes(costs, MX_A, MX_M)]}
    return out


def _mesh_facts(a: int, m: int) -> tuple:
    """(the mesh, the contracts a group is needed for, tests/test_mesh.py:
    58-80): names, shape and rank order, this rank's coordinates and
    groups, and for (A, 1) make_agent_mesh(A)'s ranks."""
    import torch.distributed as dist
    mesh = mesh_lib.make_fed_mesh(a, m, device="cpu")
    facts = {"names": tuple(mesh.mesh_dim_names),
             "ranks": mesh.mesh.tolist(),
             "coords": (mesh.get_local_rank("agents"),
                        mesh.get_local_rank("model")),
             "agents_group": dist.get_process_group_ranks(
                 mesh.get_group("agents")),
             "model_group": dist.get_process_group_ranks(
                 mesh.get_group("model"))}
    if m == 1:
        agent = mesh_lib.make_agent_mesh(a, device="cpu")
        facts["agent_mesh_ranks"] = agent.mesh.tolist()
    return mesh, facts


def _world_main(rank, world, store_path, inputs_path, out_path):
    """One rank of the spawned gloo world: every mesh, grid cell and the
    matrix cell; rank 0 writes what every rank reported."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with open(inputs_path, "rb") as f:
            grid, mx = pickle.load(f)
        mine = {"refused": []}
        for shape in ((4, 2), (3, 1), (2, 1)):
            try:
                mesh_lib.make_fed_mesh(*shape, device="cpu")
            except ValueError as e:
                mine["refused"].append((shape, str(e)))
        for a, m in MESHES:
            mesh, mine[("facts", a, m)] = _mesh_facts(a, m)
            for name, case in grid.items():
                mine[("grid", a, m, name)] = _run_grid_cell(case, mesh)
            if (a, m) == (MX_A, MX_M):
                mine["matrix"] = _run_matrix(mx, mesh)
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(every, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """What every rank of the 4-rank world reported, the reference's
    results, the dry-run record and the torchrun CLI's output: the world
    and the CLI run while this process computes the reference's side."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh2d")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    cli_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *CLI,
         "--mesh-agents", "2", "--mesh-model", "2"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    inputs, out_path = tmp / "inputs.pkl", tmp / "out.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((_grid_inputs(), _mx_inputs()), f)
    ctx = mp.start_processes(
        _world_main, args=(4, str(tmp / "store"), str(inputs),
                           str(out_path)),
        nprocs=4, start_method="spawn", join=False)
    # the reference's results and the dry run while the ranks work
    grid_want, mx_want = _grid_wants(), _mx_wants()
    record = _dryrun_record(tmp)
    while not ctx.join():
        pass
    with open(out_path, "rb") as f:
        every = pickle.load(f)
    stdout, stderr = cli_proc.communicate(timeout=240)
    return {"ranks": every, "grid_want": grid_want, "mx_want": mx_want,
            "cli": (cli_proc.returncode, stdout, stderr),
            "record": record}


def _dryrun_record(tmp):
    """The tiny LM's sharded train record with --mesh-agents 16
    --mesh-model 2, at a cut train shape (batch 32, seq 16)."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    saved = dryrun.SHAPES["train_4k"]
    dryrun.SHAPES["train_4k"] = ShapeConfig("train_4k", 32, 16, "train")
    try:
        return dryrun.run_one("tiny", "train_4k", False, str(tmp),
                              state_layout="sharded", mesh_agents=16,
                              mesh_model=2)
    finally:
        dryrun.SHAPES["train_4k"] = saved


# ---------------------------------------------------------------------------
# The 2-D engine against the reference's flat round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRID))
@pytest.mark.parametrize("a,m", MESHES, ids=[f"{a}x{m}" for a, m in MESHES])
def test_grid_cell_matches_the_reference_flat_round(world, a, m, name):
    """A grid cell at (A, M) against the reference's single-device flat
    round, within 1e-5·max|x| on the buffer, the optimizer state and the
    residual and 1e-5 relative on the losses (int8: test_torch_sharded's
    criterion); every rank ends holding the same gathered state."""
    from test_torch_sharded import _assert_state
    ranks = [r[("grid", a, m, name)] for r in world["ranks"]]
    want = dict(world["grid_want"][name])
    codec = GRID[name][0].get("codec", "none")
    for got in ranks:
        _assert_state(got, want, codec)
        np.testing.assert_array_equal(got["flat"], ranks[0]["flat"])


@pytest.mark.parametrize("name", list(GRID))
@pytest.mark.parametrize("a,m", MESHES, ids=[f"{a}x{m}" for a, m in MESHES])
def test_grid_cell_state_is_one_block_a_rank(world, a, m, name):
    """Each rank's x, optimizer-state and residual blocks are exactly
    n/A · D/M · 4 bytes, storage and elements alike (the reference's
    ``addressable_shards[0].data.nbytes`` check)."""
    opt, codec = GRID[name][1], GRID[name][0].get("codec", "none")
    blocks = 1 + (2 if opt == "adamw" else 0) \
        + (1 if codec != "none" and GRID[name][0]["gossip_impl"] != "none"
           else 0)
    for r in world["ranks"]:
        got = r[("grid", a, m, name)]["bytes"]
        assert got == [(N // a * (D // m) * 4,) * 2] * blocks


def test_matrix_cell_matches_the_reference(world):
    """tests/test_mesh.py's matrix cell at (2, 2): the end state within
    1e-5·max|x|, the losses within 1e-5, each rank's block n/A · D/M · 4
    bytes."""
    for impl in MX_IMPLS:
        want = world["mx_want"][impl]
        scale = float(np.abs(want["flat"]).max())
        for r in world["ranks"]:
            got = r["matrix"][impl]
            assert np.abs(got["flat"] - want["flat"]).max() <= TOL * scale
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=TOL, atol=TOL)
            assert got["bytes"] == [(MX_N // MX_A * (MX_D // MX_M) * 4,)
                                    * 2]


@pytest.mark.parametrize("impl,codec", TALLY,
                         ids=[f"{i}-{c}" for i, c in TALLY])
def test_matrix_cell_collectives_keep_to_their_axis(world, impl, codec):
    """One step's collectives on every rank at (2, 2), by the port's
    axis_separation: no 'mixed' or 'unknown', the gossip kinds on
    'agents' only, and 'model' carrying the line-4 all-gather (with
    int8, the scale's all-reduce) and nothing else."""
    model = ["all-gather"] + (["all-reduce"] if codec == "int8" else [])
    gossip = "reduce-scatter" if impl == "dense" else "collective-permute"
    for r in world["ranks"]:
        got = r["matrix"][f"tally-{impl}-{codec}"]
        sep = got["sep"]
        assert "mixed" not in sep and "unknown" not in sep, sep
        assert sep["model"] == sorted(model), sep
        assert gossip in sep["agents"], sep
        for kind, axis in got["axes"]:
            if kind in GOSSIP_KINDS:
                assert axis == "agents", (kind, axis)


# ---------------------------------------------------------------------------
# Mesh contracts (tests/test_mesh.py:28-80)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,m", MESHES, ids=[f"{a}x{m}" for a, m in MESHES])
def test_fed_mesh_names_shape_and_rank_order(world, a, m):
    """Names ('agents', 'model'), shape (A, M), ranks arange(A·M)
    reshaped (A, M): rank r sits at (r // M, r % M), its agents group
    {r % M, M + r % M, ...} and its model group {M·(r // M), ...}; (A, 1)
    covers make_agent_mesh(A)'s ranks in order."""
    for rank, r in enumerate(world["ranks"]):
        facts = r[("facts", a, m)]
        assert facts["names"] == ("agents", "model")
        assert facts["ranks"] == np.arange(a * m).reshape(a, m).tolist()
        assert facts["coords"] == (rank // m, rank % m)
        assert facts["agents_group"] == list(range(rank % m, a * m, m))
        assert facts["model_group"] == list(range(rank // m * m,
                                                  rank // m * m + m))
        if m == 1:
            assert np.ravel(facts["agent_mesh_ranks"]).tolist() == \
                np.ravel(facts["ranks"]).tolist()


def test_fed_mesh_refuses_a_wrong_world(world):
    """A·M must be the world's size, whether larger or smaller."""
    for r in world["ranks"]:
        assert [s for s, _ in r["refused"]] == [(4, 2), (3, 1), (2, 1)]
        for _, msg in r["refused"]:
            assert "n_agent_shards * n_model_shards == 4 ranks" in msg


@pytest.mark.parametrize("a,m", [(0, 1), (1, 0), (-1, 1), (1, -2)])
def test_fed_mesh_rejects_nonpositive_shapes(a, m):
    with pytest.raises(ValueError):
        mesh_lib.make_fed_mesh(a, m, device="cpu")


# ---------------------------------------------------------------------------
# The collective-axis classifier against the reference's
# ---------------------------------------------------------------------------

GROUP_CASES = [([[0, 1], [2, 3]], 2), ([[0, 2], [1, 3]], 2), ([[0, 3]], 2),
               ([[0, 1], [0, 2]], 2), ([[0], [1]], 2), ([[0, 1, 2, 3]], 1),
               ([[0, 1, 2, 3]], 4), ([[0, 16, 32]], 16), ([[5]], 3)]
PAIR_CASES = [([(0, 2), (2, 0), (1, 3), (3, 1)], 2), ([(0, 1), (1, 0)], 2),
              ([(0, 3)], 2), ([(0, 0)], 2), ([(1, 5), (3, 7)], 4)]


@pytest.mark.parametrize("groups,m", GROUP_CASES,
                         ids=[f"{g}/{m}" for g, m in GROUP_CASES])
def test_axis_of_groups_equals_the_reference(groups, m):
    from repro.launch import hlo_analysis
    assert trace_analysis._axis_of_groups(groups, m) == \
        hlo_analysis._axis_of_groups(groups, m)


@pytest.mark.parametrize("pairs,m", PAIR_CASES,
                         ids=[f"{p}/{m}" for p, m in PAIR_CASES])
def test_axis_of_pairs_equals_the_reference(pairs, m):
    from repro.launch import hlo_analysis
    assert trace_analysis._axis_of_pairs(pairs, m) == \
        hlo_analysis._axis_of_pairs(pairs, m)


def test_axis_separation_of_the_reference_synthetic_module():
    """The groups and pairs of tests/test_mesh.py's synthetic HLO module,
    as a tally records them, classify as the reference's axis_separation
    classifies the module itself."""
    from repro.launch import hlo_analysis
    from test_mesh import _SYNTHETIC_HLO
    costs = trace_analysis.OpCosts(collective_groups={
        ("all-reduce", (0, 1), None), ("all-reduce", (2, 3), None),
        *{("collective-permute", (0, 1, 2, 3), p)
          for p in ((0, 2), (2, 0), (1, 3), (3, 1))},
        ("reduce-scatter", (0, 2), None), ("reduce-scatter", (1, 3), None)})
    assert trace_analysis.axis_separation(costs, 2, 2) == \
        hlo_analysis.axis_separation(_SYNTHETIC_HLO, 2, 2)
    costs.collective_groups.add(("all-gather", (), None))
    assert "unknown" in trace_analysis.axis_separation(costs, 2, 2)


# ---------------------------------------------------------------------------
# model_axis_conflict: the reference's exact messages
# (tests/conformance/test_model_axis_errors.py)
# ---------------------------------------------------------------------------

FEATURES = {
    "tree": "layout 'tree' (the pytree engine has no flat buffer to "
            "column-shard)",
    "sweep": "sweep lattices (--sweep-runs) until the composition lands",
    "delta": "delta parameterization (--delta)",
    "topk": "topk gossip compression (the payload indices address the "
            "full D axis)",
}


def _canonical(feature: str) -> str:
    from repro.core import engine as ref_engine
    return str(ref_engine.model_axis_conflict(FEATURES[feature]))


def _port_cfg(codec="none", **kw):
    g = topo.geographic_graph(N, 0.6, seed=3)
    return FedDecConfig(mixing=MixingDistribution(g), h=H_CFG, k=K,
                        gossip_compress=codec, **kw)


def _duck_mesh(a: int, m: int):
    """A mesh's sizes without a group (the reference's duck-typed mesh):
    enough for the makers' checks, which run before any collective."""
    return types.SimpleNamespace(mesh_dim_names=("agents", "model"),
                                 mesh=np.zeros((a, m)))


@pytest.mark.parametrize("feature,kw", [
    ("tree", dict(layout="tree")), ("sweep", dict(force_run_axis=True)),
    ("sweep", dict(lattice=True)), ("delta", dict(delta="full")),
    ("topk", dict(codec="topk:0.25"))])
def test_parse_conflicts_give_the_reference_message(feature, kw):
    kw = dict(kw)
    cfg = _port_cfg(kw.pop("codec", "none"))
    if "delta" in kw:
        import dataclasses
        cfg = dataclasses.replace(cfg, delta=kw.pop("delta"))
    configs = [cfg, cfg] if kw.pop("lattice", False) else cfg
    with pytest.raises(ValueError) as err:
        engine.parse_engine_spec(configs, n_model_shards=2, **kw)
    assert str(err.value) == _canonical(feature)


def test_makers_give_the_reference_messages():
    """The sharded makers on a model dim of 2: top-k is the canonical
    conflict, a D that M does not divide and a missing model dim are the
    reference's ValueErrors; M = 1 takes top-k."""
    spec = flat_lib.make_flat_spec({"z": torch.zeros(D)})
    spec25 = flat_lib.make_flat_spec({"z": torch.zeros(25)})
    for maker in (sharded.make_sharded_feddec_round,
                  sharded.make_sharded_feddec_step):
        with pytest.raises(ValueError) as err:
            maker(_port_cfg("topk:0.25"), spec, None, None,
                  _duck_mesh(1, 2), device="cpu", model_axis="model")
        assert str(err.value) == _canonical("topk")
    with pytest.raises(ValueError) as err:
        sharded._validate_model_axis(_port_cfg("topk:0.25"), D,
                                     _duck_mesh(1, 2), "model")
    assert str(err.value) == _canonical("topk")
    assert sharded._validate_model_axis(_port_cfg("topk:0.25"), D,
                                        _duck_mesh(2, 1), "model") == 1
    with pytest.raises(ValueError, match="divisible by the model axis"):
        sharded._validate_model_axis(_port_cfg(), spec25.d, _duck_mesh(1, 2),
                                     "model")
    with pytest.raises(ValueError, match="mesh has no model axis"):
        sharded._validate_model_axis(_port_cfg(), D, types.SimpleNamespace(
            mesh_dim_names=("agents",), mesh=np.zeros(2)), "model")


@pytest.mark.parametrize("case", ["no-agents", "tree", "sweep", "delta"])
def test_train_loop_and_cli_give_the_reference_messages(case):
    """train_loop and the CLI raise the reference's train_loop messages
    (repro/launch/train.py:127-143), the CLI before it joins a group."""
    from repro.configs.base import FedConfig as RefFedConfig
    from repro.launch import train as ref_train
    from repro_torch.configs.base import FedConfig
    from repro_torch.launch import train as port_train
    over, argv = {
        "no-agents": (dict(mesh_agents=None), []),
        "tree": (dict(state_layout="tree"),
                 ["--mesh-agents", "2", "--state-layout", "tree"]),
        "sweep": (dict(sweep_runs=2),
                  ["--mesh-agents", "2", "--sweep-runs", "2"]),
        "delta": (dict(delta="full"),
                  ["--mesh-agents", "2", "--delta", "full"])}[case]
    delta = over.pop("delta", "none")
    kw = {**dict(steps=2, per_agent_batch=1, seq_len=8, mesh_agents=2,
                 mesh_model=2, state_layout="flat"), **over}
    with pytest.raises(ValueError) as ref_err:
        ref_train.train_loop(
            ref_train.tiny_lm_config(d_model=64, layers=1, vocab=128),
            RefFedConfig(n_agents=4, h=2, k=2, delta=delta), **kw)
    with pytest.raises(ValueError) as err:
        port_train.train_loop(
            port_train.tiny_lm_config(d_model=64, layers=1, vocab=128),
            FedConfig(n_agents=4, h=2, k=2, delta=delta), device="cpu",
            **kw)
    assert str(err.value) == str(ref_err.value)
    if case != "no-agents":
        assert str(err.value) == _canonical(case)
    with pytest.raises(ValueError) as err:
        port_train.main(["--device", "cpu", "--agents", "4", "--h", "2",
                         "--mesh-model", "2", *argv])
    assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# The CLI and the dry run
# ---------------------------------------------------------------------------


def _losses(line: str) -> list:
    """The losses of a [train] line: its numbers of four decimals."""
    return [float(w) for w in re.findall(r"\d+\.\d{4}(?!\d)", line)]


def test_cli_mesh_model_prints_the_flat_run(world, capsys):
    """--mesh-agents 2 --mesh-model 2 --device cpu under torchrun (four
    gloo ranks, started by the module's fixture) prints the flat run's
    header (with the 2-D mesh named), its step-10 loss and its done
    line, within the 4 printed decimals."""
    from repro_torch.launch import train as port_train
    rc, stdout, stderr = world["cli"]
    assert rc == 0, stderr[-2000:]
    got = [ln for ln in stdout.splitlines() if ln.startswith("[train]")]
    port_train.main(CLI)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[train]")]
    assert len(got) == len(want) == 3        # rank 0 alone prints
    assert got[0] == want[0].replace(
        "layout=flat", "layout=flat (2-D mesh: 2 agents x 2 model)")
    for g, w in zip(got[1:], want[1:]):
        assert g.split("loss")[0] == w.split("loss")[0]
        assert len(_losses(g)) == len(_losses(w)) > 0
        np.testing.assert_allclose(_losses(g), _losses(w), atol=1.5e-4)


def test_dryrun_mesh_model_record(world):
    """The tiny LM's sharded record with --mesh-agents 16 --mesh-model 2
    traces the 2-D program (rank 0 of 16 × 2 ranks): its collectives keep
    to their axes, and its mesh2d block equals the reference's
    mesh2d_cost_model on the same graph, byte for byte (its ``pred_us``
    are at the card's rates, launch/analysis.py, the reference's at its
    accelerator's: the keys must match, the times differ)."""
    from repro.core import topology as ref_topo
    from repro.launch.analysis import mesh2d_cost_model
    rec = world["record"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 32
    assert rec["axis_separation"] == {
        "model": ["all-gather"], "agents": ["all-reduce", "reduce-scatter"]}
    gm = rec["gossip_cost_model"]
    rounds = len(ref_topo.permutation_schedule(
        _ref_quotient(gm["n_agents"], 16)))
    want = mesh2d_cost_model(
        n_agents=gm["n_agents"], d=gm["d"], n_agent_shards=16,
        n_model_shards=2, num_halo_rounds=rounds,
        param_bytes=gm["param_bytes"])
    got = gm["mesh2d"]
    assert (got["n_agent_shards"], got["n_model_shards"]) == (16, 2)
    assert got["impls"].keys() == want.keys()
    for impl, row in want.items():
        assert got["impls"][impl].keys() == row.keys()
        assert {k: v for k, v in got["impls"][impl].items()
                if k != "pred_us"} == {k: v for k, v in row.items()
                                       if k != "pred_us"}
    assert got["impls"]["dense"]["state_bytes_per_device"] == \
        gm["n_agents"] // 16 * (gm["d"] // 2) * 4


def _ref_quotient(n: int, shards: int):
    """The reference's quotient of the dry run's default graph (ring2 on
    n agents) over ``shards`` blocks."""
    from repro.core import sharded as ref_sharded
    from repro.core import topology as ref_topo
    return ref_sharded.quotient_graph(ref_topo.ring_graph(n, k=2), shards)

