"""The port's sweep lattice against the JAX package's, under replayed draws.

Both sweep engines run the quadratic problem of tests/test_torch_engine.py
(written once in JAX, once in torch) on R = 3 runs of n = 5 agents,
D = 2196, from the same numpy start, for 2 rounds of 3 steps: over gossip
impl {dense, pallas, sparse} × fused update+mix {off, on} × {sgd,
momentum}, and over lattices that vary H per run, hold a FedAvg member,
mix per-run topologies with an edgeless run, fail links in one run, and
freeze a run at its step budget.  The port's draws are a replay of the
reference's per-run keys: run r's step t uses
``split(fold_in(key_r, t), 3)`` for W^t's uniforms and the server's K
draws.  On the CPU the reference runs its Pallas kernels in interpret
mode and the port its plain versions.  Tolerance: 1e-5 max abs on the
lattice buffer and the momentum slot (f32, short horizon); losses 1e-5
relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.core.mixing import identity_mixing as ref_identity_mixing
from repro_torch import optim
from repro_torch.core import engine, flat as flat_lib, gossip, sweep
from repro_torch.core import topology as topo
from repro_torch.core.draws import SweepDraws
from repro_torch.core.feddec import FedAvgConfig, FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.kernels import ops
from test_torch_engine import ref_codec_noise
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, H, K, ETA = 5, 3, 2, 0.1
SHAPES = {"b": (211,), "w": {"k": (5, 397)}}   # D = 2196
TOL = 1e-5


class ReplaySweepDraws:
    """The reference lattice's per-run draws (repro/core/sweep.py:330-333,
    :436-437, mixing.py:115-125) through the port's lattice interface."""

    def __init__(self, run_keys):
        self.run_keys = run_keys

    def _key(self, r, t, which):
        return jax.random.split(
            jax.random.fold_in(self.run_keys[r], int(t[r])), 3)[which]

    def link_uniforms(self, t, n):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(self._key(r, t, 0), (n, n)))
            for r in range(len(t))]))

    def participants(self, t, n, k):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.randint(self._key(r, t, 2), (k,), 0, n))
            for r in range(len(t))]).astype(np.int64))

    def codec_noise(self, t, n, d):
        """Run r's int8 noise ``_row_noise(split(fold_in(key_w_r, 1), n),
        d)`` (repro/core/sweep.py:357-366, :471-473)."""
        return torch.from_numpy(np.stack([
            np.asarray(ref_codec_noise(self._key(r, t, 0), n, d))
            for r in range(len(t))]))


class ReplayDraws(ReplaySweepDraws):
    """One run of the lattice, replayed for the port's flat engine."""

    def __init__(self, key):
        super().__init__([key])

    def link_uniforms(self, t, n):
        return super().link_uniforms([t], n)[0]

    def participants(self, t, n, k):
        return super().participants([t], n, k)[0]

    def codec_noise(self, t, n, d):
        return super().codec_noise([t], n, d)[0]


def _jax_loss(params, batch):
    return 0.5 * (jnp.sum(jnp.square(params["b"] - batch["tb"]))
                  + jnp.sum(jnp.square(2.0 * params["w"]["k"]
                                       - batch["tw"])))


def _torch_loss(params, batch):
    return 0.5 * (torch.sum(torch.square(params["b"] - batch["tb"]))
                  + torch.sum(torch.square(2.0 * params["w"]["k"]
                                           - batch["tw"])))


# line 4 for one agent, as the engines take it (the reference's
# jax.value_and_grad form)
_torch_grad_fn = engine.value_and_grad(_torch_loss)


def _ref_grad_fn(params, batch, key):
    del key
    return jax.value_and_grad(_jax_loss)(params, batch)


GRAPHS = {"ring2": ref_topo.ring_graph(N, k=2),
          "ring1": ref_topo.ring_graph(N, k=1),
          "geo": ref_topo.geographic_graph(N, 0.6, seed=3)}


def _cfg(graph="ring2", impl="dense", h=H, p_fail=0.0):
    """(reference config, port config) of one run."""
    if graph == "fedavg":
        return (RefFedDecConfig(mixing=ref_identity_mixing(N), h=h, k=K,
                                gossip_impl="none"),
                FedAvgConfig(N, h=h, k=K))
    g = GRAPHS[graph]
    return (RefFedDecConfig(mixing=RefMixing(g, p_fail=p_fail,
                                             scheme="metropolis"),
                            h=h, k=K, gossip_impl=impl),
            FedDecConfig(mixing=MixingDistribution(
                topo.Graph(g.adjacency), p_fail=p_fail, scheme="metropolis"),
                h=h, k=K, gossip_impl=impl))


def _opts(opt):
    return ({"sgd": None, "momentum": ref_optim.momentum_sgd()}[opt],
            {"sgd": None, "momentum": optim.momentum_sgd()}[opt])


def _ref_spec():
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    return ref_flat.make_flat_spec(shapes)


def _port_spec(ref_spec):
    params1 = flat_lib.params_from_numpy(jax.tree.map(
        np.asarray, ref_spec.unravel(jnp.zeros(ref_spec.d))))
    return flat_lib.make_flat_spec(params1)


def _rounds(r_runs, rounds=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tb": rng.standard_normal((H, r_runs, N, 211)).astype(
                 np.float32),
             "tw": rng.standard_normal((H, r_runs, N, 5, 397)).astype(
                 np.float32)} for _ in range(rounds)]


def _run_both(pairs, *, opt="sgd", fused=False, t_steps=None, rounds=2):
    """Both lattices over ``rounds`` rounds of H steps: (reference state,
    port state, reference (T, R) losses, port (T, R) losses, run keys)."""
    ref_cfgs, cfgs = zip(*pairs)
    r_runs = len(pairs)
    ref_opt, port_opt = _opts(opt)
    ref_spec = _ref_spec()
    rng = np.random.default_rng(42)
    flat0 = rng.standard_normal((r_runs, N, ref_spec.d)).astype(np.float32)
    m0 = np.zeros_like(flat0)

    ref_plan = ref_sweep.make_sweep_plan(ref_cfgs, t_steps=t_steps)
    rstate = ref_sweep.SweepFedState(
        flat=jnp.asarray(flat0), step=jnp.ones((r_runs,), jnp.int32),
        opt_state=() if ref_opt is None else jnp.asarray(m0))
    round_ref = ref_sweep.make_sweep_feddec_round(
        ref_plan, ref_spec, _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=fused)

    plan = sweep.make_sweep_plan(cfgs, t_steps=t_steps)
    state = sweep.SweepFedState(
        flat=torch.from_numpy(flat0.copy()), step=np.ones(r_runs, np.int64),
        opt_state=() if port_opt is None else torch.from_numpy(m0.copy()))
    eta = torch.tensor([ETA])
    round_fn = sweep.make_sweep_feddec_round(
        plan, _port_spec(ref_spec), _torch_grad_fn, lambda t: eta,
        device="cpu", optimizer=port_opt, fuse_update_mix=fused)

    run_keys = jax.random.split(jax.random.key(7), r_runs)
    draws = ReplaySweepDraws(run_keys)
    ref_losses, losses = [], []
    for batches in _rounds(r_runs, rounds):
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, batches),
                                 run_keys)
        ref_losses.append(np.asarray(rmet["loss"]))
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in batches.items()}, draws)
        losses.append(met["loss"].numpy())
    return (rstate, state, np.concatenate(ref_losses),
            np.concatenate(losses), run_keys)


def _assert_matches(rstate, state, ref_losses, losses):
    np.testing.assert_array_equal(state.step, np.asarray(rstate.step))
    assert np.max(np.abs(state.flat.numpy() - np.asarray(rstate.flat))) \
        <= TOL
    if not isinstance(state.opt_state, tuple):
        assert np.max(np.abs(state.opt_state.numpy()
                             - np.asarray(rstate.opt_state))) <= TOL
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)


MATRIX_GRAPHS = ("ring2", "ring1", "geo")
CELLS = [(impl, fused, opt) for impl in ("dense", "pallas", "sparse")
         for fused in (False, True) for opt in ("sgd", "momentum")]


@pytest.mark.parametrize("impl,fused,opt", CELLS,
                         ids=[f"{i}-{'fused' if f else 'unfused'}-{o}"
                              for i, f, o in CELLS])
def test_sweep_round_matches_reference(impl, fused, opt):
    """Three runs on three graphs (max degree 4, 2 and the geo graph's),
    so the stacked ELL tables pad two of them."""
    rstate, state, ref_losses, losses, _ = _run_both(
        [_cfg(g, impl) for g in MATRIX_GRAPHS], opt=opt, fused=fused)
    assert losses.shape == (2 * H, 3)
    assert list(state.step) == [1 + 2 * H] * 3
    _assert_matches(rstate, state, ref_losses, losses)


LATTICES = {
    # per-run H: run 1's first round fires at t = 5, run 0's at 2 and 5
    # (ring1: on n = 5 ring2 is complete, and a server round after its mix
    # would change nothing)
    "h-axis": ([("ring1", "pallas", 3, 0.0), ("ring1", "pallas", 6, 0.0)],
               "sgd", False),
    # a FedAvg member (W = I through the batched kernels) beside FedDec
    "fedavg-member": ([("ring1", "pallas", 3, 0.0), ("fedavg",)],
                      "momentum", True),
    "fedavg-member-unfused": ([("ring1", "pallas", 3, 0.0), ("fedavg",)],
                              "sgd", False),
    # per-run topologies with an edgeless run (stacked ELL, padded)
    "topologies-edgeless": ([("geo", "sparse", 3, 0.0),
                             ("ring1", "sparse", 3, 0.0), ("fedavg",)],
                            "sgd", True),
    "topologies-edgeless-unfused": ([("ring2", "sparse", 3, 0.0),
                                     ("fedavg",)], "momentum", False),
    # link failures in one run: its W^t is resampled every step
    "p-fail": ([("ring2", "sparse", 3, 0.2), ("ring1", "sparse", 3, 0.0)],
               "momentum", True),
    "p-fail-dense": ([("ring2", "dense", 3, 0.2), ("geo", "dense", 3, 0.0)],
                     "sgd", False),
}


@pytest.mark.parametrize("name", list(LATTICES))
def test_lattice_matches_reference(name):
    runs, opt, fused = LATTICES[name]
    rstate, state, ref_losses, losses, _ = _run_both(
        [_cfg(*run) for run in runs], opt=opt, fused=fused)
    _assert_matches(rstate, state, ref_losses, losses)


@pytest.mark.parametrize("impl,fused", [("pallas", True), ("sparse", False)])
def test_budget_freezes_a_run_bit_for_bit(impl, fused):
    """Run 0 stops after 2 steps and run 2 after 4 of 6: their flat, step
    and momentum slot stay as they were, bit for bit, and the lattice
    still matches the reference's masked engine."""
    budgets = (2, 2 * H, 4)
    pairs = [_cfg(g, impl) for g in MATRIX_GRAPHS]
    rstate, state, ref_losses, losses, _ = _run_both(
        pairs, opt="momentum", fused=fused, t_steps=budgets)
    _assert_matches(rstate, state, ref_losses, losses)
    np.testing.assert_array_equal(state.step, np.asarray(budgets) + 1)

    # the same lattice step by step: the frozen slices never move again
    _, cfgs = zip(*pairs)
    plan = sweep.make_sweep_plan(cfgs, t_steps=budgets)
    ref_spec = _ref_spec()
    step = sweep.make_sweep_feddec_step(
        plan, _port_spec(ref_spec), _torch_grad_fn,
        lambda t: torch.tensor([ETA]), device="cpu",
        optimizer=optim.momentum_sgd(), fuse_update_mix=fused)
    rng = np.random.default_rng(42)
    flat0 = rng.standard_normal((3, N, ref_spec.d)).astype(np.float32)
    st = sweep.SweepFedState(flat=torch.from_numpy(flat0),
                             step=np.ones(3, np.int64),
                             opt_state=torch.zeros(3, N, ref_spec.d))
    draws = ReplaySweepDraws(jax.random.split(jax.random.key(7), 3))
    batches = _rounds(3)
    at_budget = {}
    for t in range(1, 2 * H + 1):
        b = batches[(t - 1) // H]
        st, met = step(st, {k: torch.from_numpy(v[(t - 1) % H])
                            for k, v in b.items()}, draws)
        assert met["active"].tolist() == [t <= bt for bt in budgets]
        for r, bt in enumerate(budgets):
            if t == bt:
                at_budget[r] = (st.flat[r].clone(), st.opt_state[r].clone())
    for r in (0, 2):
        assert torch.equal(st.flat[r], at_budget[r][0])
        assert torch.equal(st.opt_state[r], at_budget[r][1])
    assert torch.equal(st.flat, state.flat)


@pytest.mark.parametrize("impl,fused,opt", [
    ("dense", False, "momentum"), ("pallas", True, "sgd"),
    ("sparse", True, "momentum"), ("sparse", False, "sgd")])
def test_slices_equal_the_flat_engine(impl, fused, opt):
    """Each run slice of the lattice is the port's own flat engine on that
    run's config, given that run's draws."""
    pairs = [_cfg(g, impl, h=h, p_fail=p) for g, h, p in
             (("ring2", 3, 0.2), ("ring1", 6, 0.0), ("geo", 3, 0.0))]
    _, state, _, _, run_keys = _run_both(pairs, opt=opt, fused=fused)
    ref_spec = _ref_spec()
    spec = _port_spec(ref_spec)
    rng = np.random.default_rng(42)
    flat0 = rng.standard_normal((3, N, ref_spec.d)).astype(np.float32)
    _, port_opt = _opts(opt)
    for r, (_, cfg) in enumerate(pairs):
        fstate = flat_lib.FlatFedState(
            flat=torch.from_numpy(flat0[r].copy()), step=1,
            opt_state=() if port_opt is None else torch.zeros(N, spec.d))
        round_fn = flat_lib.make_flat_feddec_round(
            cfg, spec, _torch_grad_fn, lambda t: torch.tensor([ETA]),
            device="cpu", optimizer=port_opt, fuse_update_mix=fused)
        for batches in _rounds(3):
            fstate, _ = round_fn(fstate, {k: torch.from_numpy(v[:, r])
                                          for k, v in batches.items()},
                                 ReplayDraws(run_keys[r]))
        run = sweep.slice_run(state, r)
        assert run.step == fstate.step
        torch.testing.assert_close(run.flat, fstate.flat, atol=TOL, rtol=0)
        if port_opt is not None:
            torch.testing.assert_close(run.opt_state, fstate.opt_state,
                                       atol=TOL, rtol=0)


def _plan_errors(ref_cfgs, cfgs, **kw):
    with pytest.raises(ValueError) as ref_err:
        ref_sweep.make_sweep_plan(ref_cfgs, **kw)
    with pytest.raises(ValueError) as err:
        sweep.make_sweep_plan(cfgs, **kw)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("case", ["empty", "n_agents", "k", "server",
                                  "impls", "t_steps"])
def test_plan_validation_raises_the_reference_messages(case):
    base = _cfg("ring2", "dense")
    if case == "empty":
        return _plan_errors([], [])
    if case == "t_steps":
        return _plan_errors(*zip(base, base), t_steps=(3,))
    if case == "impls":
        other = _cfg("ring1", "sparse")
    elif case == "n_agents":
        g = ref_topo.ring_graph(N + 1, k=2)
        other = (RefFedDecConfig(mixing=RefMixing(g, scheme="metropolis")),
                 FedDecConfig(mixing=MixingDistribution(
                     topo.Graph(g.adjacency), scheme="metropolis")))
    else:
        field = {"k": "k", "server": "server_enabled"}[case]
        value = {"k": K + 1, "server": False}[case]
        import dataclasses
        other = tuple(dataclasses.replace(c, **{field: value}) for c in base)
    _plan_errors(*zip(base, other))


def test_plan_stacks_the_lattice_like_the_reference():
    pairs = [_cfg("ring2", "pallas", h=3, p_fail=0.2), _cfg("fedavg"),
             _cfg("geo", "pallas", h=6)]
    ref_plan = ref_sweep.make_sweep_plan([p[0] for p in pairs])
    plan = sweep.make_sweep_plan([p[1] for p in pairs])
    assert plan.gossip_impl == ref_plan.gossip_impl == "pallas"
    for field in ("h", "w_fixed", "adjacency", "p_fail", "stochastic",
                  "none_mask"):
        np.testing.assert_array_equal(getattr(plan, field),
                                      getattr(ref_plan, field))


def test_w_sampler_matches_reference():
    pairs = [_cfg("ring2", "dense", p_fail=0.4), _cfg("geo", "dense"),
             _cfg("ring1", "dense", p_fail=0.2), _cfg("fedavg")]
    ref_plan = ref_sweep.make_sweep_plan([p[0] for p in pairs])
    plan = sweep.make_sweep_plan([p[1] for p in pairs])
    keys = jax.random.split(jax.random.key(3), 4)
    want = ref_sweep.make_sweep_w_sampler(ref_plan)(keys)
    draws = ReplaySweepDraws(keys)
    draws._key = lambda r, t, which: keys[r]
    got = sweep.make_sweep_w_sampler(plan, "cpu")(draws, np.zeros(4, int))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_stack_and_slice_roundtrip():
    rng = np.random.default_rng(1)
    states = [flat_lib.FlatFedState(
        flat=torch.from_numpy(rng.standard_normal((N, 7)).astype(
            np.float32)), step=s, opt_state=torch.full((N, 7), float(s)))
        for s in (1, 4, 9)]
    stacked = sweep.stack_flat_states(states)
    assert stacked.flat.shape == (3, N, 7) and list(stacked.step) == [1, 4, 9]
    for r, st in enumerate(states):
        back = sweep.slice_run(stacked, r)
        assert torch.equal(back.flat, st.flat) and back.step == st.step
        assert torch.equal(back.opt_state, st.opt_state)
    sgd = sweep.stack_flat_states([flat_lib.FlatFedState(
        flat=torch.zeros(N, 3), step=1)] * 2)
    assert sgd.opt_state == () and sweep.slice_run(sgd, 1).opt_state == ()


def test_init_state_matches_reference():
    ref_spec = _ref_spec()
    pairs = [_cfg("ring2"), _cfg("ring1")]
    params = jax.tree.map(lambda s: jnp.full(s, 0.5, jnp.float32), SHAPES,
                          is_leaf=lambda s: isinstance(s, tuple))
    want = ref_sweep.init_sweep_state(
        ref_sweep.make_sweep_plan([p[0] for p in pairs]), ref_spec, params,
        optimizer=ref_optim.momentum_sgd())
    got = sweep.init_sweep_state(
        sweep.make_sweep_plan([p[1] for p in pairs]), _port_spec(ref_spec),
        flat_lib.params_from_numpy(jax.tree.map(np.asarray, params)),
        optimizer=optim.momentum_sgd())
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))
    np.testing.assert_array_equal(got.opt_state.numpy(),
                                  np.asarray(want.opt_state))
    np.testing.assert_array_equal(got.step, np.asarray(want.step))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_optimizers_broadcast_a_per_run_eta(opt):
    """The port's optimizers take η of shape (R, 1, 1) as they stand: each
    run's slice is the single-run update with that run's η."""
    o = {"sgd": optim.sgd(), "momentum": optim.momentum_sgd(),
         "nesterov": optim.momentum_sgd(nesterov=True)}[opt]
    rng = np.random.default_rng(2)
    x, g, m = (torch.from_numpy(rng.standard_normal((3, N, 9)).astype(
        np.float32)) for _ in range(3))
    state = () if opt == "sgd" else m
    eta = torch.tensor([0.1, 0.2, 0.3])
    y, new = o.update(x, g, state, eta.reshape(3, 1, 1))
    for r in range(3):
        yr, nr = o.update(x[r], g[r], () if opt == "sgd" else m[r],
                          eta[r:r + 1])
        assert torch.equal(y[r], yr)
        if opt != "sgd":
            assert torch.equal(new[r], nr)


def test_edgeless_run_is_identity():
    rng = np.random.default_rng(4)
    graphs = [topo.ring_graph(6, k=1), topo.Graph(np.zeros((6, 6), bool))]
    w = torch.stack([torch.as_tensor(
        topo.metropolis_weights(graphs[0]), dtype=torch.float32),
        torch.eye(6)])
    x = torch.from_numpy(rng.standard_normal((2, 6, 40)).astype(np.float32))
    for mix in (ops.gossip_mix_batched,
                gossip.make_sparse_gossip_batched(graphs),
                gossip.make_sparse_gossip_batched(graphs[1:] * 2)):
        assert torch.equal(mix(w, x)[1], x[1])


@pytest.mark.parametrize("graphs", ["ring-geo", "edgeless", "star"])
def test_sparse_batched_matches_reference_and_single_run(graphs):
    """The stacked-ELL mix (kernel #6's plain version in range, the plain
    stacked ELL outside it) against the reference's, and each slice
    against the port's single-run sparse mix."""
    n = {"ring-geo": 6, "edgeless": 6, "star": 20}[graphs]
    if graphs == "ring-geo":
        ref_graphs = [ref_topo.ring_graph(n, k=1),
                      ref_topo.geographic_graph(n, 0.7, seed=2)]
    elif graphs == "edgeless":
        ref_graphs = [ref_topo.Graph(np.zeros((n, n), bool))] * 2
    else:  # one hub above ELL_MAX_DEG
        adj = np.zeros((n, n), dtype=bool)
        adj[0, 1:] = adj[1:, 0] = True
        ref_graphs = [ref_topo.Graph(adj), ref_topo.ring_graph(n, k=1)]
    port_graphs = [topo.Graph(g.adjacency) for g in ref_graphs]
    ws = jnp.stack([RefMixing(g, p_fail=0.3, scheme="metropolis").sample(
        jax.random.key(r)) for r, g in enumerate(ref_graphs)])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, n, 250)).astype(np.float32)
    from repro.core import gossip as ref_gossip
    want = ref_gossip.make_sparse_gossip_batched(ref_graphs)(
        ws, jnp.asarray(x))
    tw, tx = torch.from_numpy(np.array(ws)), torch.from_numpy(x)
    got = gossip.make_sparse_gossip_batched(port_graphs)(tw, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for r, g in enumerate(port_graphs):
        torch.testing.assert_close(
            got[r], gossip.make_sparse_gossip(g)(tw[r], tx[r]), atol=1e-6,
            rtol=0)


def test_lattice_ell_tables_match_reference():
    ref_graphs = [ref_topo.ring_graph(8, k=1),
                  ref_topo.geographic_graph(8, 0.5, seed=1),
                  ref_topo.Graph(np.zeros((8, 8), bool))]
    from repro.core import gossip as ref_gossip
    want = ref_gossip.stacked_ell_tables(ref_graphs)
    got = gossip.stacked_ell_tables([topo.Graph(g.adjacency)
                                     for g in ref_graphs])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert gossip.lattice_max_degree([topo.Graph(g.adjacency)
                                      for g in ref_graphs]) == \
        ref_gossip.lattice_max_degree(ref_graphs)


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse", "none"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "custom"])
@pytest.mark.parametrize("graphs", ["rings", "edgeless"])
def test_sweep_fuse_kind_matches_reference(impl, opt, graphs):
    names = ["ring2", "ring1"] if graphs == "rings" else ["fedavg", "fedavg"]
    pairs = [_cfg(g, impl) if g != "fedavg" else _cfg(g) for g in names]
    if graphs == "edgeless":  # an impl over edgeless graphs (W = I)
        pairs = [(RefFedDecConfig(mixing=ref_identity_mixing(N),
                                  gossip_impl=impl),
                  FedDecConfig(mixing=MixingDistribution(
                      topo.Graph(np.zeros((N, N), bool)),
                      scheme="metropolis"), gossip_impl=impl))] * 2
    ref_opt = {"sgd": None, "momentum": ref_optim.momentum_sgd(),
               "custom": ref_optim.adamw()}[opt]
    port_opt = {"sgd": None, "momentum": optim.momentum_sgd(),
                "custom": optim.Optimizer(lambda p: (),
                                          lambda p, g, s, lr: (p, s))}[opt]
    assert sweep._sweep_fuse_kind(
        sweep.make_sweep_plan([p[1] for p in pairs]), port_opt) == \
        ref_sweep._sweep_fuse_kind(
            ref_sweep.make_sweep_plan([p[0] for p in pairs]), ref_opt)


def test_resolve_gossip_sweep_dispatch():
    plan = sweep.make_sweep_plan([_cfg("ring2", "pallas")[1]] * 2)
    assert engine.resolve_gossip(plan, "sweep") is ops.gossip_mix_batched
    assert sweep.resolve_sweep_gossip(plan) is ops.gossip_mix_batched
    x = torch.randn(2, N, 10)
    none = sweep.make_sweep_plan([FedAvgConfig(N)] * 2)
    assert engine.resolve_gossip(none, "sweep")(None, x) is x
    dense = sweep.make_sweep_plan([_cfg("ring2", "dense")[1]] * 2)
    w = torch.rand(2, N, N)
    torch.testing.assert_close(engine.resolve_gossip(dense, "sweep")(w, x),
                               torch.bmm(w, x), atol=1e-6, rtol=0)


def test_sweep_draws_share_or_split_the_engine_stream():
    shared = SweepDraws(3, "cpu", 3, per_run=False)
    u = shared.link_uniforms(np.ones(3, int), 4)
    assert u.shape == (3, 4, 4) and torch.equal(u[0], u[2])
    p = shared.participants(np.ones(3, int), 4, 2)
    assert p.shape == (3, 2) and torch.equal(p[0], p[1])
    split = SweepDraws(3, "cpu", 3, per_run=True)
    u = split.link_uniforms(np.ones(3, int), 4)
    assert not torch.equal(u[0], u[1])
    again = SweepDraws(3, "cpu", 3, per_run=True)
    assert torch.equal(again.link_uniforms(np.ones(3, int), 4), u)
    # the shared generator (weights, data, tokens) is the single run's
    from repro_torch.core.draws import Draws
    assert torch.equal(SweepDraws(5, "cpu", 2, True).uniform((4,)),
                       Draws(5, "cpu").uniform((4,)))


def test_server_round_fires_only_where_due():
    class Fixed:
        def participants(self, t, n, k):
            return torch.tensor([[0, 0], [1, 2], [3, 3]])

    flat = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2)
    before = flat.clone()
    from repro_torch.core import server
    out = server.server_round_sweep(Fixed(), None, flat, 2,
                                    np.array([True, False, True]))
    assert out is flat
    assert torch.equal(flat[0], before[0, 0].expand(4, 2))
    assert torch.equal(flat[1], before[1])
    assert torch.equal(flat[2], before[2, 3].expand(4, 2))


def test_executors_donate_the_input_state():
    plan = sweep.make_sweep_plan([_cfg("ring2", "dense")[1]] * 2)
    spec = flat_lib.make_flat_spec({"b": torch.zeros(4)})
    state = sweep.SweepFedState(flat=torch.ones(2, N, 4),
                                step=np.ones(2, np.int64))
    old = state.flat
    step = sweep.make_sweep_feddec_step(
        plan, spec, engine.value_and_grad(lambda p, b: p["b"].sum()),
        lambda t: torch.tensor([0.1]), device="cpu")
    new, met = step(state, {"x": torch.zeros(2, N, 1)},
                    SweepDraws(0, "cpu", 2, per_run=False))
    assert new is state and list(state.step) == [2, 2]
    assert state.flat is not old and met["loss"].shape == (2,)
    torch.testing.assert_close(state.flat, torch.full((2, N, 4), 0.9))


def test_per_step_keys_are_not_ported():
    plan = sweep.make_sweep_plan([_cfg("ring2")[1]])
    spec = flat_lib.make_flat_spec({"b": torch.zeros(4)})
    with pytest.raises(ValueError, match="not ported"):
        sweep.make_sweep_feddec_round(plan, spec, None, None, device="cpu",
                                      per_step_keys=True)
