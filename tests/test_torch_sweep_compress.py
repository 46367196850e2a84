"""The port's compressed sweep lattice against the JAX package's, under
replayed draws.

Both sweep engines run the quadratic problem of tests/test_torch_sweep.py
with a codec shared by the lattice (``gossip_compress``): R = 3 runs of
n = 5 agents on three graphs (so the stacked ELL tables pad two of them),
D = 2196, across gossip impl {dense, pallas, sparse} × fused update+mix ×
{sgd, momentum} × codec {identity, bf16, int8, topk:0.25}, and on
lattices that vary H per run (the draws shared by the runs, as on the
CLI's h axis), hold a FedAvg member, mix per-run topologies, fail links
in one run, and freeze runs at their step budgets.  Each cell starts both
packages from the reference's lattice after one round (its residual
carried in), then runs 2 more rounds of H = 3 in both.  Run r's int8
noise replays ``_row_noise(split(fold_in(key_w_r, 1), n), d)``
(ReplaySweepDraws).  On the CPU the reference runs its Pallas kernels in
interpret mode and the port its plain versions.

Also here: the plain versions of kernels #10/#12 against the reference's
Pallas kernels, each run's slice of the lattice against the port's flat
compressed engine on that run, and the whole slice (train_loop) against
the reference trainer.

Tolerances.  identity: 1e-5 max abs on the lattice buffer and the
momentum slot, losses 1e-5 relative, as the uncompressed lattice.  The
lossy codecs by the rounding-flip rule of tests/test_torch_compress.py:
the losses within 1e-4 relative; at least 99% of the elements of x and
of the residual within 1e-5·max|x|; every element within one rounding
step.  FedAvg members, frozen runs and the identity codec against the
uncompressed lattice: bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as RefFedConfig
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.kernels import ops as ref_ops
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.core import compress, engine, flat as flat_lib, sweep
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws, SweepDraws
from repro_torch.kernels import ops
from repro_torch.launch import train as port_train
from test_torch_compress import _assert_close_lossy, _bits, _u_bound
from test_torch_sweep import (ETA, H, MATRIX_GRAPHS, N, TOL, ReplayDraws,
                              ReplaySweepDraws, _cfg as _plain_cfg, _opts,
                              _port_spec, _ref_spec, _rounds, _torch_loss,
                              _ref_grad_fn)
from test_torch_train import ReplaySweepTrainDraws

CODECS = ["identity", "bf16", "int8", "topk:0.25"]


def _cfg(graph="ring2", impl="dense", codec="int8", h=H, p_fail=0.0):
    """(reference config, port config) of one run with the lattice's codec
    (a FedAvg member carries it too: the codec is shared by the lattice,
    repro/core/sweep.py:141-143)."""
    pair = _plain_cfg(graph, impl, h=h, p_fail=p_fail)
    return tuple(dataclasses.replace(c, gossip_compress=codec) for c in pair)


def _start(r_runs: int, opt: str, compressed: bool):
    """The lattice's numpy start: flat, momentum slot, residual."""
    d = _ref_spec().d
    flat0 = np.random.default_rng(42).standard_normal(
        (r_runs, N, d)).astype(np.float32)
    zeros = np.zeros_like(flat0)
    return flat0, (zeros if opt == "momentum" else None), \
        (zeros if compressed else None)


def _port_state(flat, step, opt_state, residual) -> sweep.SweepFedState:
    def tensor(a):
        return () if a is None else torch.from_numpy(np.array(a))
    return sweep.SweepFedState(flat=tensor(flat),
                               step=np.array(step, dtype=np.int64),
                               opt_state=tensor(opt_state),
                               residual=tensor(residual))


def _port_round(plan, opt, fused, per_step=False):
    _, port_opt = _opts(opt)
    eta = torch.tensor([ETA])
    kw = dict(device="cpu", optimizer=port_opt, fuse_update_mix=fused)
    spec = _port_spec(_ref_spec())
    if per_step:
        return engine.make_loop_round(sweep.make_sweep_feddec_step(
            plan, spec, _torch_loss, lambda t: eta, **kw))
    return sweep.make_sweep_feddec_round(plan, spec, _torch_loss,
                                         lambda t: eta, **kw)


def _run_keys(r_runs: int, shared: bool = False):
    if shared:  # the CLI's h and topology axes: one key stream for all
        return jnp.broadcast_to(jax.random.key(7)[None], (r_runs,))
    return jax.random.split(jax.random.key(7), r_runs)


def _run_both(pairs, *, opt="sgd", fused=False, t_steps=None,
              shared_keys=False, rounds=2):
    """One reference round from the numpy start, then ``rounds`` more in
    both packages from the reference's lattice (its residual included):
    (reference states, port state, reference (T, R) losses, port (T, R)
    losses)."""
    ref_cfgs, cfgs = zip(*pairs)
    r_runs = len(pairs)
    ref_opt, _ = _opts(opt)
    ref_plan = ref_sweep.make_sweep_plan(ref_cfgs, t_steps=t_steps)
    flat0, m0, res0 = _start(r_runs, opt, True)
    rstate = ref_sweep.SweepFedState(
        flat=jnp.asarray(flat0), step=jnp.ones((r_runs,), jnp.int32),
        opt_state=() if m0 is None else jnp.asarray(m0),
        residual=jnp.asarray(res0))
    round_ref = ref_sweep.make_sweep_feddec_round(
        ref_plan, _ref_spec(), _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=fused)
    run_keys = _run_keys(r_runs, shared_keys)
    batches = _rounds(r_runs, rounds + 1)
    rstate, _ = round_ref(rstate, jax.tree.map(jnp.asarray, batches[0]),
                          run_keys)
    states = [rstate]
    state = _port_state(rstate.flat, rstate.step,
                        None if m0 is None else rstate.opt_state,
                        rstate.residual)
    round_fn = _port_round(sweep.make_sweep_plan(cfgs, t_steps=t_steps),
                           opt, fused)
    draws = ReplaySweepDraws(run_keys)
    ref_losses, losses = [], []
    for b in batches[1:]:
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, b),
                                 run_keys)
        states.append(rstate)
        ref_losses.append(np.asarray(rmet["loss"]))
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, draws)
        losses.append(met["loss"].numpy())
    return states, state, np.concatenate(ref_losses), \
        np.concatenate(losses)


def _assert_matches(states, state, ref_losses, losses, codec):
    """identity within 1e-5; a lossy codec by the rounding-flip rule."""
    rstate = states[-1]
    np.testing.assert_array_equal(state.step, np.asarray(rstate.step))
    x, rx = state.flat.numpy(), np.asarray(rstate.flat)
    res, rres = state.residual.numpy(), np.asarray(rstate.residual)
    if codec == "identity":
        assert np.max(np.abs(x - rx)) <= TOL
        assert not res.any() and not rres.any()
        if not isinstance(state.opt_state, tuple):
            assert np.max(np.abs(state.opt_state.numpy()
                                 - np.asarray(rstate.opt_state))) <= TOL
        np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
        return
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    k = compress.parse_compress(codec).k_of(x.shape[-1]) \
        if codec.startswith("topk") else 0
    bound = _u_bound(codec, states, k)
    scale = float(np.abs(rx).max())
    _assert_close_lossy(x, rx, scale, bound)
    _assert_close_lossy(res, rres, scale, bound)
    assert np.abs(rres).max() > 0  # the lossy codec left a residual


# ---------------------------------------------------------------------------
# The engine against the reference's
# ---------------------------------------------------------------------------

CELLS = [(impl, fused, opt, codec) for codec in CODECS
         for impl in ("dense", "pallas", "sparse")
         for fused in (False, True) for opt in ("sgd", "momentum")]


@pytest.mark.parametrize(
    "impl,fused,opt,codec", CELLS,
    ids=[f"{c}-{i}-{'fused' if f else 'unfused'}-{o}"
         for i, f, o, c in CELLS])
def test_compressed_lattice_matches_reference(impl, fused, opt, codec):
    states, state, ref_losses, losses = _run_both(
        [_cfg(g, impl, codec) for g in MATRIX_GRAPHS], opt=opt,
        fused=fused)
    assert losses.shape == (2 * H, 3)
    assert list(state.step) == [1 + 3 * H] * 3
    _assert_matches(states, state, ref_losses, losses, codec)


LATTICES = {
    # per-run H with one key stream (the CLI's h axis): run 1's server
    # round fires on t = 5, run 0's on 2 and 5
    "h-axis-int8": ([("ring1", "pallas", 3), ("ring1", "pallas", 6)],
                    "int8", "sgd", False, True),
    "h-axis-topk-fused": ([("ring1", "pallas", 3), ("ring1", "pallas", 6)],
                          "topk:0.25", "momentum", True, True),
    # a FedAvg member bypasses the codec beside a compressed FedDec run
    "fedavg-member-fused": ([("ring1", "pallas", 3), ("fedavg",)], "int8",
                            "momentum", True, False),
    "fedavg-member-unfused": ([("ring1", "dense", 3), ("fedavg",)], "bf16",
                              "sgd", False, False),
    # per-run topologies (stacked ELL tables, padded), one edgeless member
    "topologies-fused": ([("geo", "sparse", 3), ("ring1", "sparse", 3),
                          ("fedavg",)], "int8", "sgd", True, False),
    "topologies-unfused": ([("ring2", "sparse", 3), ("geo", "sparse", 3)],
                           "topk:0.25", "momentum", False, False),
    # link failures in one run: its W^t resampled every step
    "p-fail-sparse": ([("ring2", "sparse", 3, 0.2), ("ring1", "sparse", 3)],
                      "int8", "momentum", True, False),
    "p-fail-dense": ([("ring2", "dense", 3, 0.2), ("geo", "dense", 3)],
                     "bf16", "sgd", False, False),
}


def _pairs(runs, codec):
    return [_cfg(run[0], codec=codec) if run[0] == "fedavg"
            else _cfg(run[0], run[1], codec, *run[2:]) for run in runs]


@pytest.mark.parametrize("name", list(LATTICES))
def test_compressed_lattice_variants_match_reference(name):
    runs, codec, opt, fused, shared = LATTICES[name]
    states, state, ref_losses, losses = _run_both(
        _pairs(runs, codec), opt=opt, fused=fused, shared_keys=shared)
    _assert_matches(states, state, ref_losses, losses, codec)


def _run_port(pairs, *, opt="sgd", fused=False, per_step=False,
              t_steps=None, rounds=2):
    """The port alone from the numpy start (zero residual), replayed
    draws: (state, (T, R) losses)."""
    cfgs = [c for _, c in pairs]
    plan = sweep.make_sweep_plan(cfgs, t_steps=t_steps)
    compressed = sweep._compressor(plan) is not None
    flat0, m0, res0 = _start(len(cfgs), opt, compressed)
    state = _port_state(flat0, np.ones(len(cfgs)), m0, res0)
    round_fn = _port_round(plan, opt, fused, per_step=per_step)
    draws = ReplaySweepDraws(_run_keys(len(cfgs)))
    losses = []
    for b in _rounds(len(cfgs), rounds):
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, draws)
        losses.append(met["loss"].numpy())
    return state, np.concatenate(losses)


@pytest.mark.parametrize("fused,opt,codec", [
    (True, "momentum", "int8"), (False, "sgd", "topk:0.25"),
    (True, "sgd", "bf16"), (False, "momentum", "int8")])
def test_fedavg_member_is_the_uncompressed_run(fused, opt, codec):
    """The FedAvg member of a compressed lattice ends where the same member
    of the uncompressed lattice ends, bit for bit, its residual zero."""
    runs = [("ring1", "pallas", 3), ("fedavg",)]
    a, la = _run_port(_pairs(runs, codec), opt=opt, fused=fused)
    b, lb = _run_port(_pairs(runs, "none"), opt=opt, fused=fused)
    assert torch.equal(a.flat[1], b.flat[1])
    np.testing.assert_array_equal(la[:, 1], lb[:, 1])
    if opt == "momentum":
        assert torch.equal(a.opt_state[1], b.opt_state[1])
    assert not a.residual[1].any() and a.residual[0].abs().max() > 0
    assert b.residual == ()


@pytest.mark.parametrize("impl,fused,codec", [
    ("pallas", True, "int8"), ("sparse", False, "topk:0.25"),
    ("dense", True, "bf16"), ("sparse", True, "identity")])
def test_budget_freezes_flat_opt_state_and_residual(impl, fused, codec):
    """Run 0 stops after 2 steps (in the reference's first round) and run 2
    after 5 of 9: the lattice matches the reference's masked engine, and
    step by step the frozen runs' flat, momentum slot and residual stay
    as they were at their budget, bit for bit."""
    budgets = (2, 3 * H, 5)
    pairs = [_cfg(g, impl, codec) for g in MATRIX_GRAPHS]
    states, state, ref_losses, losses = _run_both(
        pairs, opt="momentum", fused=fused, t_steps=budgets)
    _assert_matches(states, state, ref_losses, losses, codec)
    np.testing.assert_array_equal(state.step, np.asarray(budgets) + 1)

    # the port alone, one step at a time from the same start
    plan = sweep.make_sweep_plan([c for _, c in pairs], t_steps=budgets)
    _, port_opt = _opts("momentum")
    step = sweep.make_sweep_feddec_step(
        plan, _port_spec(_ref_spec()), _torch_loss,
        lambda t: torch.tensor([ETA]), device="cpu", optimizer=port_opt,
        fuse_update_mix=fused)
    flat0, m0, res0 = _start(3, "momentum", True)
    st = _port_state(flat0, np.ones(3), m0, res0)
    draws = ReplaySweepDraws(_run_keys(3))
    batches = _rounds(3, 3)
    at_budget = {}
    for t in range(1, 3 * H + 1):
        b = batches[(t - 1) // H]
        st, met = step(st, {k: torch.from_numpy(v[(t - 1) % H])
                            for k, v in b.items()}, draws)
        assert met["active"].tolist() == [t <= bt for bt in budgets]
        for r, bt in enumerate(budgets):
            if t == bt:
                at_budget[r] = tuple(a[r].clone() for a in
                                     (st.flat, st.opt_state, st.residual))
    for r in (0, 2):
        for now, then in zip((st.flat, st.opt_state, st.residual),
                             at_budget[r]):
            assert torch.equal(now[r], then)
    np.testing.assert_array_equal(st.step, np.asarray(budgets) + 1)
    if codec != "identity":
        assert at_budget[0][2].abs().max() > 0  # a residual was frozen
    # the round executor on the same start ends on the same lattice
    rounds, _ = _run_port(pairs, opt="momentum", fused=fused,
                          t_steps=budgets, rounds=3)
    for a, b in zip((st.flat, st.opt_state, st.residual),
                    (rounds.flat, rounds.opt_state, rounds.residual)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_identity_is_the_uncompressed_lattice(impl, fused):
    """identity: s = u = x_half, so y = W x_half + diag·0 and the residual
    stays 0: the uncompressed lattice to 0.0 (chip_smoke.py path (q))."""
    runs = [("ring2", impl, 3), ("ring1", impl, 6), ("fedavg",)]
    a, la = _run_port(_pairs(runs, "identity"), opt="momentum",
                      fused=fused)
    b, lb = _run_port(_pairs(runs, "none"), opt="momentum", fused=fused)
    np.testing.assert_array_equal(la, lb)
    assert (a.flat - b.flat).abs().max().item() == 0.0
    assert torch.equal(a.opt_state, b.opt_state)
    assert not a.residual.any() and b.residual == ()


@pytest.mark.parametrize("codec", ["bf16", "int8", "topk:0.25"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_fused_matches_unfused_under_a_codec(codec, impl):
    """The fused EF op (#10/#12) and the unfused EF gossip (the lattice's
    mix, then the diagonal term) share the codec: the same payloads, the
    mix within f32 noise."""
    pairs = [_cfg(g, impl, codec) for g in MATRIX_GRAPHS]
    a, la = _run_port(pairs, opt="momentum", fused=True)
    b, lb = _run_port(pairs, opt="momentum", fused=False)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    torch.testing.assert_close(a.flat, b.flat, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a.residual, b.residual, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl,fused,opt,codec", [
    ("dense", False, "momentum", "int8"), ("pallas", True, "sgd",
                                           "topk:0.25"),
    ("sparse", True, "momentum", "int8"), ("sparse", False, "sgd", "bf16"),
    ("pallas", False, "momentum", "identity")])
def test_slices_equal_the_flat_compressed_engine(impl, fused, opt, codec):
    """Each run slice of the compressed lattice is the port's own flat
    compressed engine on that run's config, given that run's draws."""
    pairs = [_cfg(g, impl, codec, h=h, p_fail=p) for g, h, p in
             (("ring2", 3, 0.2), ("ring1", 6, 0.0), ("geo", 3, 0.0))]
    state, _ = _run_port(pairs, opt=opt, fused=fused)
    spec = _port_spec(_ref_spec())
    flat0, m0, res0 = _start(3, opt, True)
    _, port_opt = _opts(opt)
    run_keys = _run_keys(3)
    for r, (_, cfg) in enumerate(pairs):
        fstate = flat_lib.FlatFedState(
            flat=torch.from_numpy(flat0[r].copy()), step=1,
            opt_state=() if m0 is None else torch.from_numpy(m0[r].copy()),
            residual=torch.from_numpy(res0[r].copy()))
        round_fn = flat_lib.make_flat_feddec_round(
            cfg, spec, _torch_loss, lambda t: torch.tensor([ETA]),
            device="cpu", optimizer=port_opt, fuse_update_mix=fused)
        for batches in _rounds(3):
            fstate, _ = round_fn(fstate, {k: torch.from_numpy(v[:, r])
                                          for k, v in batches.items()},
                                 ReplayDraws(run_keys[r]))
        run = sweep.slice_run(state, r)
        assert run.step == fstate.step
        x, fx = run.flat.numpy(), fstate.flat.numpy()
        res, fres = run.residual.numpy(), fstate.residual.numpy()
        if codec == "identity":
            assert np.max(np.abs(x - fx)) <= TOL and not res.any()
            continue
        k = compress.parse_compress(codec).k_of(spec.d) \
            if codec.startswith("topk") else 0
        bound = _u_bound(codec, [fstate], k)
        scale = float(np.abs(fx).max())
        _assert_close_lossy(x, fx, scale, bound)
        _assert_close_lossy(res, fres, scale, bound)


# ---------------------------------------------------------------------------
# Plain versions of kernels #10 and #12 against the reference's Pallas
# kernels (interpret mode on the CPU)
# ---------------------------------------------------------------------------

LATTICE_SHAPES = [(1, 5, 1031), (3, 8, 300), (2, 13, 517), (3, 3, 77),
                  (2, 6, 129)]


def _lattice_inputs(r: int, n: int, d: int, seed: int):
    """Per-run graphs (ring2 and a geographic graph, the last run edgeless
    when R > 1: the stacked ELL tables pad), their sampled Ws with link
    failures, and p, s, u with rows of different scales."""
    rng = np.random.default_rng(seed)
    graphs = [ref_topo.ring_graph(n, k=min(2, (n - 1) // 2 or 1))
              if i % 3 != 1 else ref_topo.geographic_graph(n, 0.7, seed=i)
              for i in range(r)]
    if r > 1:
        graphs[-1] = ref_topo.Graph(np.zeros((n, n), dtype=bool))
    w = np.stack([np.asarray(RefMixing(g, p_fail=0.3, scheme="metropolis")
                             .sample(jax.random.key(seed + i)), np.float32)
                  for i, g in enumerate(graphs)])
    p, s, u = (rng.standard_normal((r, n, d)).astype(np.float32)
               for _ in range(3))
    u[:, 0] *= 40.0
    return graphs, w, p, s, u


def _assert_ef(got, want) -> None:
    """y within 1e-5 (another summation order), r bit for bit."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))


@pytest.mark.parametrize("r,n,d", LATTICE_SHAPES)
def test_ef_mix_batched_plain_matches_reference(r, n, d):
    _, w, p, s, u = _lattice_inputs(r, n, d, seed=r * 97 + n + d)
    ops.reset_launch_counts()
    got = ops.ef_mix_batched(*map(torch.from_numpy, (w, p, s, u)))
    want = ref_ops.ef_mix_batched(*map(jnp.asarray, (w, p, s, u)))
    _assert_ef(got, want)
    assert ops.launch_counts()["ef_mix_batched"] == 0  # CPU: plain


@pytest.mark.parametrize("r,n,d", LATTICE_SHAPES)
def test_ef_mix_sparse_batched_plain_matches_reference(r, n, d):
    graphs, w, p, s, u = _lattice_inputs(r, n, d, seed=r * 89 + n + d)
    ops.reset_launch_counts()
    got = ops.make_sparse_ef_mix_batched(
        [topo.Graph(g.adjacency) for g in graphs])(
        *map(torch.from_numpy, (w, p, s, u)))
    want = ref_ops.make_sparse_ef_mix_batched_pallas(graphs)(
        *map(jnp.asarray, (w, p, s, u)))
    _assert_ef(got, want)
    assert ops.launch_counts()["ef_mix_sparse_batched"] == 0


@pytest.mark.parametrize("r,n,d", LATTICE_SHAPES[1:])
def test_batched_ef_slices_are_the_single_run_mix(r, n, d):
    """Each run's slice of plain #10 is plain #9 on it, and of plain #12
    (the lattice's padded ELL tables) plain #11 on the run's own table,
    bit for bit."""
    graphs, w, p, s, u = _lattice_inputs(r, n, d, seed=r + n + d)
    tw, tp, ts, tu = map(torch.from_numpy, (w, p, s, u))
    port_graphs = [topo.Graph(g.adjacency) for g in graphs]
    dense = ops.ef_mix_batched(tw, tp, ts, tu)
    sparse = ops.make_sparse_ef_mix_batched(port_graphs)(tw, tp, ts, tu)
    for i, g in enumerate(port_graphs):
        for got, want in ((dense, ops.ef_mix(tw[i], tp[i], ts[i], tu[i])),
                          (sparse, ops.make_sparse_ef_mix(g)(
                              tw[i], tp[i], ts[i], tu[i]))):
            for a, b in zip(got, want):
                assert torch.equal(a[i], b)


def test_batched_ef_wrappers_reject_what_the_kernels_do_not_take():
    w, p = torch.eye(3).expand(2, 3, 3).contiguous(), torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):  # (n, D): the single-run wrapper's
        ops.ef_mix_batched(w[0], p[0], p[0], p[0])
    with pytest.raises(ValueError):  # one W per run
        ops.ef_mix_batched(w[:1], p, p, p)
    with pytest.raises(ValueError):
        ops.ef_mix_batched(w, p, p, torch.zeros(2, 3, 9))
    with pytest.raises(TypeError):
        ops.ef_mix_batched(w, p, p.double(), p)
    ef = ops.make_sparse_ef_mix_batched([topo.ring_graph(3, k=1)] * 2)
    with pytest.raises(ValueError):  # three runs for a two-run table
        ef(torch.eye(3).expand(3, 3, 3), *(torch.zeros(3, 3, 8),) * 3)


# ---------------------------------------------------------------------------
# Plan, state and draws
# ---------------------------------------------------------------------------


def test_plan_takes_a_shared_codec_and_rejects_a_mixed_one():
    pairs = [_cfg("ring2", "pallas", "int8"), _cfg("fedavg", codec="int8")]
    ref_plan = ref_sweep.make_sweep_plan([p[0] for p in pairs])
    plan = sweep.make_sweep_plan([p[1] for p in pairs])
    assert plan.gossip_compress == ref_plan.gossip_compress == "int8"
    mixed = [_cfg("ring2", "pallas", "int8"), _cfg("ring1", "pallas", "bf16")]
    with pytest.raises(ValueError) as ref_err:
        ref_sweep.make_sweep_plan([p[0] for p in mixed])
    with pytest.raises(ValueError) as err:
        sweep.make_sweep_plan([p[1] for p in mixed])
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("runs,codec", [
    ([("ring2", "pallas"), ("fedavg",)], "int8"),
    ([("ring2", "sparse"), ("ring1", "sparse")], "topk:0.25"),
    ([("ring2", "dense")], "none"),
    ([("fedavg",), ("fedavg",)], "int8")])
def test_init_state_matches_reference(runs, codec):
    """A zero (R, n, D) residual under a codec, none without one or in an
    all-FedAvg lattice (nothing is exchanged)."""
    pairs = _pairs(runs, codec)
    ref_spec = _ref_spec()
    params = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, jnp.float32),
                          ref_spec.unravel(jnp.zeros(ref_spec.d)))
    want = ref_sweep.init_sweep_state(
        ref_sweep.make_sweep_plan([p[0] for p in pairs]), ref_spec, params)
    got = sweep.init_sweep_state(
        sweep.make_sweep_plan([p[1] for p in pairs]), _port_spec(ref_spec),
        flat_lib.params_from_numpy(jax.tree.map(np.asarray, params)))
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))
    if isinstance(want.residual, tuple):
        assert got.residual == ()
    else:
        np.testing.assert_array_equal(got.residual.numpy(),
                                      np.asarray(want.residual))


def test_stack_and_slice_carry_the_residual():
    rng = np.random.default_rng(3)
    states = [flat_lib.FlatFedState(
        flat=torch.from_numpy(rng.standard_normal((N, 7)).astype(
            np.float32)), step=s, opt_state=torch.full((N, 7), float(s)),
        residual=torch.full((N, 7), -float(s))) for s in (1, 4)]
    stacked = sweep.stack_flat_states(states)
    assert stacked.residual.shape == (2, N, 7)
    for r, st in enumerate(states):
        back = sweep.slice_run(stacked, r)
        assert torch.equal(back.residual, st.residual)
        assert torch.equal(back.opt_state, st.opt_state)
    plain = sweep.stack_flat_states([flat_lib.FlatFedState(
        flat=torch.zeros(N, 3), step=1)] * 2)
    assert plain.residual == () and sweep.slice_run(plain, 0).residual == ()


def test_sweep_draws_codec_noise_per_run_or_shared():
    shared = SweepDraws(3, "cpu", 3, per_run=False)
    u = shared.codec_noise(np.ones(3, int), 4, 6)
    assert u.shape == (3, 4, 6) and u.stride(0) == 0  # one draw, no copy
    assert torch.equal(u[0], u[2])
    assert torch.equal(u[0], Draws(3, "cpu").codec_noise(1, 4, 6))
    split = SweepDraws(3, "cpu", 3, per_run=True)
    u = split.codec_noise(np.ones(3, int), 4, 6)
    assert u.shape == (3, 4, 6) and not torch.equal(u[0], u[1])
    for r, run in enumerate(SweepDraws(3, "cpu", 3, per_run=True).runs):
        assert torch.equal(u[r], run.codec_noise(1, 4, 6))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


class _CountingDraws(ReplaySweepDraws):
    def __init__(self, run_keys):
        super().__init__(run_keys)
        self.noise_calls = 0

    def codec_noise(self, t, n, d):
        self.noise_calls += 1
        return super().codec_noise(t, n, d)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_only_int8_draws_codec_noise(codec, fused):
    """identity, bf16 and top-k lattices consume exactly the uncompressed
    lattice's draws; int8 draws its (R, n, D) noise once per step."""
    pairs = [_cfg(g, "pallas", codec) for g in ("ring2", "ring1")]
    plan = sweep.make_sweep_plan([c for _, c in pairs])
    step = sweep.make_sweep_feddec_step(
        plan, _port_spec(_ref_spec()), _torch_loss,
        lambda t: torch.tensor([ETA]), device="cpu", fuse_update_mix=fused)
    flat0, _, res0 = _start(2, "sgd", True)
    probe = _CountingDraws(_run_keys(2))
    batch = {k: torch.from_numpy(v[0]) for k, v in _rounds(2, 1)[0].items()}
    step(_port_state(flat0, np.ones(2), None, res0), batch, probe)
    assert probe.noise_calls == (codec == "int8")


# ---------------------------------------------------------------------------
# The whole slice: train_loop against the reference trainer
# ---------------------------------------------------------------------------

D_MODEL, LAYERS, VOCAB, SEQ, BATCH, N_LM, H_LM, K_LM = \
    64, 2, 256, 16, 2, 4, 2, 2


class ReplayCodecSweepTrainDraws(ReplaySweepTrainDraws):
    """The reference sweep trainer's draws with run r's int8 noise,
    ``_row_noise(split(fold_in(key_w_r, 1), n), d)``."""

    def codec_noise(self, t, n, d):
        from test_torch_engine import ref_codec_noise
        return torch.from_numpy(np.stack([np.asarray(ref_codec_noise(
            self._run_key(r, t, 0), n, d)) for r in range(len(t))]))


@pytest.mark.parametrize("axis,impl,fuse,opt,codec", [
    ("seed", "pallas", True, "momentum", "int8"),
    ("h", "sparse", False, "sgd", "topk:0.25")])
def test_compressed_sweep_train_loop_matches_reference(axis, impl, fuse,
                                                       opt, codec):
    """The small LM as an R = 2 compressed lattice through both trainers:
    per-step lattice-mean losses within 1e-4 relative (the lossy rule)."""
    seed = 3
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB)
    fed = dict(n_agents=N_LM, h=H_LM, k=K_LM, graph="ring2",
               gossip_impl=impl, gossip_compress=codec)
    kw = dict(steps=4, per_agent_batch=BATCH, seq_len=SEQ, fused=True,
              fuse_update_mix=fuse, optimizer=opt, log_every=0, seed=seed,
              sweep_runs=2, sweep_axis=axis)
    _, ref_losses = ref_train.train_loop(ref_cfg, RefFedConfig(**fed),
                                         state_layout="flat", **kw)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayCodecSweepTrainDraws(
        seed, ref_make_data(VOCAB, N_LM, SEQ, alpha=0.3, seed=seed), 2,
        axis)
    state, losses = port_train.train_loop(
        port_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB),
        FedConfig(**fed), device="cpu", draws=draws, keep_lattice=True,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)), **kw)
    assert len(losses) == len(ref_losses) == 4
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert list(state.step) == [5, 5]
    assert state.residual.shape == state.flat.shape
    assert state.residual.abs().max() > 0
