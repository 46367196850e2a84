"""The port's engine dispatcher (EngineSpec, parse_engine_spec,
make_engine_step/round) against the JAX package's, mirroring
tests/conformance/test_engine_spec.py and
tests/conformance/test_gossip_errors.py.

Validation: the port's spec fields and every error message equal the
reference's for the same configs.  Lowering: the quadratic problem of
tests/test_torch_sweep.py (n = 5 agents, D = 2196) through the port's and
the reference's ``make_engine_round`` under the reference's replayed
draws (``ReplayDraws``, ``ReplaySweepDraws``), flat buffers within ATOL
= 1e-5·max|x| (the conformance suite's acceptance tolerance, f32, other
summation order), losses 1e-5 relative; the port's own makers and its
dispatcher give the same trajectories bit for bit.  The reference's
hypothesis properties run here as parametrized cases.  The sharded
lowerings (a mesh, ``n_shards`` or ``n_model_shards`` > 1) are not
ported: where the reference lowers one, the port raises
NotImplementedError (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import engine as ref_engine
from repro.core import feddec as ref_feddec
from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro_torch.core import engine, feddec, fedavg, flat as flat_lib
from repro_torch.core import sweep
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from test_torch_sweep import (ETA, H, N, ReplayDraws, ReplaySweepDraws,
                              _cfg, _port_spec, _ref_grad_fn, _ref_spec,
                              _rounds, _torch_grad_fn)

ATOL = 1e-5          # × max|x|: the conformance suite's tolerance, f32
T_RUN = 2 * H        # two rounds; crosses the server boundaries at 3, 6
BOGUS = "broadcast"


def make_cfgs(gossip_impl="dense", codec="none", h=4, k=2, n=8,
              p_fail=0.0):
    """(reference, port) configs of tests/conformance/_equiv.py's cell:
    the geographic graph of radius 0.6 on n agents."""
    g = ref_topo.geographic_graph(n, 0.6, seed=3)
    scheme = "metropolis" if p_fail else "laplacian"
    return (RefFedDecConfig(mixing=RefMixing(g, p_fail=p_fail,
                                             scheme=scheme),
                            h=h, k=k, gossip_impl=gossip_impl,
                            gossip_compress=codec),
            FedDecConfig(mixing=MixingDistribution(
                topo.Graph(g.adjacency), p_fail=p_fail, scheme=scheme),
                h=h, k=k, gossip_impl=gossip_impl, gossip_compress=codec))


def _same_error(ref_call, port_call, exc=ValueError):
    with pytest.raises(exc) as ref_err:
        ref_call()
    with pytest.raises(exc) as err:
        port_call()
    assert str(err.value) == str(ref_err.value)
    return str(err.value)


def _spec_fields(spec):
    return (spec.layout, spec.n_shards, spec.t_steps, spec.force_run_axis,
            spec.delta, spec.n_model_shards, spec.fuse_update_mix,
            spec.r_runs, spec.has_run_axis, spec.is_sharded,
            spec.is_model_sharded)


# ---------------------------------------------------------------------------
# parse_engine_spec validation (tests/conformance/test_engine_spec.py)
# ---------------------------------------------------------------------------


def test_single_config_equals_singleton_tuple():
    rcfg, cfg = make_cfgs()
    a = engine.parse_engine_spec(cfg)
    b = engine.parse_engine_spec((cfg,))
    assert a == b
    assert a.r_runs == 1 and not a.has_run_axis and not a.is_sharded
    assert a.cfg is cfg
    assert _spec_fields(a) == _spec_fields(ref_engine.parse_engine_spec(
        rcfg))


def test_force_run_axis_keeps_run_axis_for_single_run():
    rcfg, cfg = make_cfgs()
    spec = engine.parse_engine_spec(cfg, force_run_axis=True)
    assert spec.r_runs == 1 and spec.has_run_axis
    assert _spec_fields(spec) == _spec_fields(ref_engine.parse_engine_spec(
        rcfg, force_run_axis=True))
    assert spec.plan().r_runs == 1


def test_tree_layout_rejects_run_batching():
    rcfg, cfg = make_cfgs()
    for kw, configs in ((dict(), 2), (dict(force_run_axis=True), 1),
                        (dict(n_shards=2), 1)):
        msg = _same_error(
            lambda: ref_engine.parse_engine_spec([rcfg] * configs,
                                                 layout="tree", **kw),
            lambda: engine.parse_engine_spec([cfg] * configs,
                                             layout="tree", **kw))
        assert ("does not shard the agent axis" if "n_shards" in kw
                else "layout 'tree' lowers a single") in msg


def test_shards_must_divide_agents():
    rcfg, cfg = make_cfgs()   # n_agents = 8
    msg = _same_error(lambda: ref_engine.parse_engine_spec(rcfg, n_shards=3),
                      lambda: engine.parse_engine_spec(cfg, n_shards=3))
    assert "divisible by the agent axis" in msg


def test_unknown_layout_rejected():
    rcfg, cfg = make_cfgs()
    msg = _same_error(lambda: ref_engine.parse_engine_spec(rcfg,
                                                           layout="ring"),
                      lambda: engine.parse_engine_spec(cfg, layout="ring"))
    assert "unknown engine layout" in msg


def test_empty_lattice_rejected():
    msg = _same_error(lambda: ref_engine.parse_engine_spec(()),
                      lambda: engine.parse_engine_spec(()))
    assert "at least one run config" in msg


def test_t_steps_normalised_to_int_tuple():
    _, cfg = make_cfgs()
    spec = engine.parse_engine_spec([cfg, cfg],
                                    t_steps=np.asarray([2.0, 6.0]))
    assert spec.t_steps == (2, 6)
    assert all(isinstance(t, int) for t in spec.t_steps)
    np.testing.assert_array_equal(spec.plan().t_steps, [2, 6])


def test_mismatched_lattice_rejected_at_parse_time():
    """Multi-run specs run the full SweepPlan validation during parse, not
    at first lowering."""
    (r2, c2), (r3, c3) = make_cfgs(k=2), make_cfgs(k=3)
    _same_error(lambda: ref_engine.parse_engine_spec([r2, r3]),
                lambda: engine.parse_engine_spec([c2, c3]))


# ---------------------------------------------------------------------------
# Freeze-masking semantics of t_steps budgets
# ---------------------------------------------------------------------------


def _start(d):
    rng = np.random.default_rng(42)
    return np.tile(rng.standard_normal(d).astype(np.float32), (N, 1))


def _steps_batches():
    """T_RUN steps of the quadratic's batches, (T, n, ...) per leaf."""
    rounds = _rounds(1, rounds=2)
    return {k: np.concatenate([r[k][:, 0] for r in rounds])
            for k in rounds[0]}


def _run_budgeted_lattice(budget: int):
    """A 2-run lattice with budgets (budget, T_RUN), both runs the same
    config, start and batches: run 0's final buffer through the port's
    dispatcher and the reference's, and the port's flat engine stopped at
    ``budget`` steps of the same stream."""
    rcfg, cfg = _cfg("ring1", "dense")
    ref_spec = _ref_spec()
    spec = _port_spec(ref_spec)
    flat0 = _start(spec.d)
    batches = _steps_batches()
    key = jax.random.key(5)

    resp = ref_engine.parse_engine_spec([rcfg, rcfg],
                                        t_steps=(budget, T_RUN))
    ref_round = ref_engine.make_engine_round(
        resp, _ref_grad_fn, lambda t: jnp.asarray(ETA, jnp.float32),
        flat_spec=ref_spec, donate=False)
    rstate = ref_sweep.SweepFedState(
        flat=jnp.asarray(np.stack([flat0, flat0])),
        step=jnp.ones((2,), jnp.int32))
    keys = jax.random.wrap_key_data(jnp.stack([jax.random.key_data(key)]
                                              * 2))
    rb = {k: jnp.broadcast_to(jnp.asarray(v)[:, None],
                              (v.shape[0], 2) + v.shape[1:])
          for k, v in batches.items()}
    rstate, _ = ref_round(rstate, rb, keys)

    espec = engine.parse_engine_spec([cfg, cfg], t_steps=(budget, T_RUN))
    round_fn = engine.make_engine_round(
        espec, _torch_grad_fn, lambda t: torch.tensor([ETA]), device="cpu",
        flat_spec=spec)
    state = sweep.SweepFedState(
        flat=torch.from_numpy(np.stack([flat0, flat0])),
        step=np.ones(2, np.int64))
    pb = {k: torch.from_numpy(v)[:, None].expand(
        (v.shape[0], 2) + v.shape[1:]) for k, v in batches.items()}
    state, _ = round_fn(state, pb, ReplaySweepDraws([key, key]))

    flat_round = flat_lib.make_flat_feddec_round(
        cfg, spec, _torch_grad_fn, lambda t: torch.tensor([ETA]),
        device="cpu")
    fstate = flat_lib.FlatFedState(flat=torch.from_numpy(flat0.copy()),
                                   step=1)
    fstate, _ = flat_round(fstate, {k: torch.from_numpy(v[:budget])
                                    for k, v in batches.items()},
                           ReplayDraws(key))
    return (sweep.slice_run(state, 0).flat.numpy(),
            np.asarray(rstate.flat)[0], fstate.flat.numpy())


def _assert_budgeted(budget):
    run0, ref_run0, flat = _run_budgeted_lattice(budget)
    scale = np.abs(ref_run0).max()
    assert np.abs(run0 - flat).max() <= ATOL * scale
    assert np.abs(run0 - ref_run0).max() <= ATOL * scale


def test_frozen_run_never_updates_past_budget():
    """Run 0 at budget 1 equals the flat engine stopped after 1 step,
    though the lattice ran all T_RUN steps."""
    _assert_budgeted(1)


def test_full_budget_is_a_noop_mask():
    _assert_budgeted(T_RUN)


# ---------------------------------------------------------------------------
# The reference's property tests, as parametrized cases
# ---------------------------------------------------------------------------


def _flat_run(cfg, key_seed):
    """The port's flat engine on the quadratic for T_RUN steps under the
    reference's draws from ``key_seed``: (flat, losses, residual)."""
    spec = _port_spec(_ref_spec())
    state = flat_lib.init_flat_state(
        spec, spec.unravel(torch.from_numpy(_start(spec.d)[0])), N,
        compress=cfg.gossip_compress)
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, _torch_grad_fn, lambda t: torch.tensor([ETA]),
        device="cpu")
    state, met = round_fn(state, {k: torch.from_numpy(v) for k, v in
                                  _steps_batches().items()},
                          ReplayDraws(jax.random.key(key_seed)))
    return state.flat, met["loss"], state.residual


def _ref_flat_run(rcfg, key_seed):
    ref_spec = _ref_spec()
    round_fn = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), donate=False)
    state = ref_flat.init_flat_state(
        ref_spec, ref_spec.unravel(jnp.asarray(_start(ref_spec.d)[0])), N,
        compress=rcfg.gossip_compress)
    state, met = round_fn(state, jax.tree.map(jnp.asarray,
                                              _steps_batches()),
                          jax.random.key(key_seed))
    return np.asarray(state.flat), np.asarray(met["loss"])


@pytest.mark.parametrize("seed", [0, 5, 4242, 2 ** 16])
def test_identity_codec_bit_exact_property(seed):
    """For these key seeds: the identity codec with error feedback gives
    the codec-off flat trajectory bit for bit, and the reference's within
    ATOL."""
    (rnone, none), (_, ident) = _cfg("geo", "dense"), _cfg("geo", "dense")
    ident = dataclasses.replace(ident, gossip_compress="identity")
    got, got_l, res = _flat_run(ident, seed)
    ref, ref_l, _ = _flat_run(none, seed)
    assert torch.equal(got, ref) and torch.equal(got_l, ref_l)
    assert not res.any()
    want, want_l = _ref_flat_run(rnone, seed)
    assert np.abs(got.numpy() - want).max() <= ATOL * np.abs(want).max()
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=ATOL)


@pytest.mark.parametrize("budget", list(range(1, T_RUN + 1)))
def test_budget_freeze_property(budget):
    """For every budget 1..T_RUN: the frozen run's slice equals the flat
    engine stopped at that budget (and the reference's lattice)."""
    _assert_budgeted(budget)


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("force_run_axis", [False, True])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
def test_lattice_roundtrip_property(r, force_run_axis, shard):
    """For every lattice size: a valid spec round-trips through parse with
    the reference's run/shard-axis accounting, and its plan re-validates
    (parsing a sharded spec is validation only; see the lowering test)."""
    rcfg, cfg = make_cfgs()
    kw = dict(n_shards=2 if shard else 1, force_run_axis=force_run_axis)
    spec = engine.parse_engine_spec([cfg] * r, **kw)
    assert spec.r_runs == r
    assert spec.has_run_axis == (r > 1 or force_run_axis)
    assert spec.is_sharded == shard
    assert _spec_fields(spec) == _spec_fields(
        ref_engine.parse_engine_spec([rcfg] * r, **kw))
    plan = spec.plan()
    assert plan.r_runs == r and plan.n_agents == cfg.n_agents


# ---------------------------------------------------------------------------
# Lowering: the dispatcher, the makers and the reference
# ---------------------------------------------------------------------------


def _lower_both(kind, via_maker):
    """One round of T_RUN steps of ``kind`` ('tree', 'flat', 'sweep')
    through the port (its dispatcher, or the maker that shims over it with
    ``via_maker``) and the reference's dispatcher: (port flat buffer, its
    losses, reference flat buffer, reference losses)."""
    rcfg, cfg = _cfg("geo", "dense")
    ref_spec = _ref_spec()
    spec = _port_spec(ref_spec)
    flat0 = _start(spec.d)
    batches = _steps_batches()
    key = jax.random.key(11)
    lr = lambda t: torch.tensor([ETA])  # noqa: E731
    ref_lr = lambda t: jnp.asarray(ETA, jnp.float32)  # noqa: E731
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    jb = jax.tree.map(jnp.asarray, batches)
    if kind == "sweep":
        tb = {k: v[:, None] for k, v in tb.items()}
        jb = {k: v[:, None] for k, v in jb.items()}
        flat0 = flat0[None]

    if kind == "tree":
        espec = engine.parse_engine_spec(cfg, layout="tree")
        round_fn = feddec.make_feddec_round(cfg, _torch_grad_fn, lr,
                                            device="cpu") if via_maker \
            else engine.make_engine_round(espec, _torch_grad_fn, lr,
                                          device="cpu")
        state = feddec.FedState(
            params=spec.unflatten(torch.from_numpy(flat0.copy())), step=1)
        draws = ReplayDraws(key)
        rround = ref_engine.make_engine_round(
            ref_engine.parse_engine_spec(rcfg, layout="tree"),
            _ref_grad_fn, ref_lr, donate=False)
        rstate = ref_feddec.FedState(
            params=ref_spec.unflatten(jnp.asarray(flat0)),
            step=jnp.asarray(1, jnp.int32))
        rkey = key
    elif kind == "flat":
        espec = engine.parse_engine_spec(cfg)
        round_fn = flat_lib.make_flat_feddec_round(
            cfg, spec, _torch_grad_fn, lr, device="cpu") if via_maker \
            else engine.make_engine_round(espec, _torch_grad_fn, lr,
                                          device="cpu", flat_spec=spec)
        state = flat_lib.FlatFedState(flat=torch.from_numpy(flat0.copy()),
                                      step=1)
        draws = ReplayDraws(key)
        rround = ref_engine.make_engine_round(
            ref_engine.parse_engine_spec(rcfg), _ref_grad_fn, ref_lr,
            flat_spec=ref_spec, donate=False)
        rstate = ref_flat.FlatFedState(flat=jnp.asarray(flat0),
                                       step=jnp.asarray(1, jnp.int32))
        rkey = key
    else:
        espec = engine.parse_engine_spec(cfg, force_run_axis=True)
        plan = sweep.make_sweep_plan([cfg])
        round_fn = sweep.make_sweep_feddec_round(
            plan, spec, _torch_grad_fn, lr, device="cpu") if via_maker \
            else engine.make_engine_round(espec, _torch_grad_fn, lr,
                                          device="cpu", flat_spec=spec)
        state = sweep.SweepFedState(flat=torch.from_numpy(flat0.copy()),
                                    step=np.ones(1, np.int64))
        draws = ReplaySweepDraws([key])
        rround = ref_engine.make_engine_round(
            ref_engine.parse_engine_spec(rcfg, force_run_axis=True),
            _ref_grad_fn, ref_lr, flat_spec=ref_spec, donate=False)
        rstate = ref_sweep.SweepFedState(flat=jnp.asarray(flat0),
                                         step=jnp.ones((1,), jnp.int32))
        rkey = jax.random.wrap_key_data(jax.random.key_data(key)[None])
    state, met = round_fn(state, tb, draws)
    rstate, rmet = rround(rstate, jb, rkey)
    if kind == "tree":
        got = spec.flatten(state.params)
        want = np.asarray(ref_spec.flatten(rstate.params))
    else:
        got, want = state.flat, np.asarray(rstate.flat)
    return got, met["loss"], want, np.asarray(rmet["loss"])


@pytest.mark.parametrize("kind", ["tree", "flat", "sweep"])
def test_engine_round_lowers_each_kind_as_the_makers_and_the_reference(
        kind):
    """make_engine_round on a tree, a flat and a sweep spec: the same
    trajectory as the port's maker of that engine, bit for bit, and the
    reference's make_engine_round within ATOL."""
    got, loss, want, ref_loss = _lower_both(kind, via_maker=False)
    via, via_loss, _, _ = _lower_both(kind, via_maker=True)
    assert torch.equal(got, via) and torch.equal(loss, via_loss)
    assert loss.shape == ref_loss.shape
    assert np.abs(got.numpy() - want).max() <= ATOL * np.abs(want).max()
    np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=ATOL)


def test_engine_step_is_one_step_of_the_round():
    _, cfg = _cfg("ring2", "pallas")
    spec = _port_spec(_ref_spec())
    espec = engine.parse_engine_spec(cfg, fuse_update_mix=True)
    lr = lambda t: torch.tensor([ETA])  # noqa: E731
    step = engine.make_engine_step(espec, _torch_grad_fn, lr, device="cpu",
                                   flat_spec=spec)
    round_fn = engine.make_engine_round(espec, _torch_grad_fn, lr,
                                        device="cpu", flat_spec=spec)
    batches = {k: torch.from_numpy(v) for k, v in _steps_batches().items()}
    a = flat_lib.FlatFedState(flat=torch.from_numpy(_start(spec.d)), step=1)
    b = flat_lib.FlatFedState(flat=torch.from_numpy(_start(spec.d)), step=1)
    key = jax.random.key(3)
    for h in range(T_RUN):
        a, _ = step(a, {k: v[h] for k, v in batches.items()},
                    ReplayDraws(key))
    b, _ = round_fn(b, batches, ReplayDraws(key))
    assert torch.equal(a.flat, b.flat) and a.step == b.step == T_RUN + 1


@pytest.mark.parametrize("case", ["gossip_fn_sweep", "per_step_keys_flat",
                                  "per_step_keys_tree", "delta_base",
                                  "no_flat_spec"])
def test_lowering_checks_are_the_reference_messages(case):
    rcfg, cfg = make_cfgs()
    ref_spec = _ref_spec()
    spec = _port_spec(ref_spec)
    kw, rkw = dict(device="cpu", flat_spec=spec), dict(flat_spec=ref_spec)
    layout, force = "flat", False
    if case == "gossip_fn_sweep":
        force = True
        kw["gossip_fn"] = rkw["gossip_fn"] = lambda w, x: x
    elif case.startswith("per_step_keys"):
        kw["per_step_keys"] = rkw["per_step_keys"] = True
        layout = case.rsplit("_", 1)[1]
    elif case == "delta_base":
        kw["delta_base"], rkw["delta_base"] = torch.zeros(spec.d), \
            jnp.zeros(spec.d)
    else:
        del kw["flat_spec"], rkw["flat_spec"]
    espec = engine.parse_engine_spec(cfg, layout=layout,
                                     force_run_axis=force)
    respec = ref_engine.parse_engine_spec(rcfg, layout=layout,
                                          force_run_axis=force)
    _same_error(lambda: ref_engine.make_engine_round(
        respec, _ref_grad_fn, None, **rkw),
        lambda: engine.make_engine_round(espec, _torch_grad_fn, None, **kw))


def test_sweep_per_step_keys_names_round_draws():
    _, cfg = make_cfgs()
    espec = engine.parse_engine_spec([cfg, cfg])
    with pytest.raises(ValueError, match="RoundDraws"):
        engine.make_engine_round(espec, _torch_grad_fn, None, device="cpu",
                                 flat_spec=_port_spec(_ref_spec()),
                                 per_step_keys=True)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of one rank in this process and its 1-D agent mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_agent_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_agent_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [dict(n_shards=2), dict(n_model_shards=2),
                                dict(mesh=True),
                                dict(mesh=True, lattice=True)],
                         ids=["n_shards", "n_model_shards", "mesh",
                              "mesh_lattice"])
def test_sharded_lowerings_are_not_ported(kw, world_of_one):
    """The sharded kinds of the dispatch (repro/core/engine.py:555-569):
    a sharded spec without a mesh fails with the reference's message; a
    mesh (of one rank here) lowers the sharded engine, with a run axis the
    sharded lattice; only the 2-D lowering (n_model_shards > 1) is not
    ported and raises NotImplementedError."""
    kw = dict(kw)
    rcfg, cfg = make_cfgs()
    lattice = kw.pop("lattice", False)
    configs = [cfg, cfg] if lattice else cfg
    mesh = world_of_one if kw.pop("mesh", False) else None
    espec = engine.parse_engine_spec(configs, **kw)
    if mesh is None:
        respec = ref_engine.parse_engine_spec(
            [rcfg, rcfg] if lattice else rcfg, **kw)
        for ref_make, make in ((ref_engine.make_engine_step,
                                engine.make_engine_step),
                               (ref_engine.make_engine_round,
                                engine.make_engine_round)):
            _same_error(
                lambda: ref_make(respec, _ref_grad_fn, None,
                                 flat_spec=_ref_spec()),
                lambda: make(espec, _torch_grad_fn, None, device="cpu",
                             flat_spec=_port_spec(_ref_spec())))
        return
    assert engine._dispatch(espec, _port_spec(_ref_spec()), mesh) == (
        "sharded_sweep" if lattice else "sharded")
    for make in (engine.make_engine_step, engine.make_engine_round):
        assert callable(make(espec, _torch_grad_fn, None, device="cpu",
                             flat_spec=_port_spec(_ref_spec()), mesh=mesh))
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.make_engine_step(engine.parse_engine_spec(
            cfg, n_model_shards=2), _torch_grad_fn, None, device="cpu",
            flat_spec=_port_spec(_ref_spec()), mesh=mesh)


def test_makers_take_the_device_as_a_required_keyword():
    _, cfg = make_cfgs()
    with pytest.raises(TypeError, match="device"):
        feddec.make_feddec_round(cfg, _torch_grad_fn, None)
    with pytest.raises(TypeError, match="device"):
        feddec.make_feddec_step(cfg, _torch_grad_fn, None)
    with pytest.raises(TypeError, match="device"):
        fedavg.make_fedavg_round(4, _torch_grad_fn, None)
    with pytest.raises(TypeError, match="device"):
        fedavg.make_fedavg_step(4, _torch_grad_fn, None)


# ---------------------------------------------------------------------------
# The canonical unknown-gossip_impl error (test_gossip_errors.py)
# ---------------------------------------------------------------------------


def _forged(cls, good):
    """A config carrying an impl its constructor would reject."""
    cfg = object.__new__(cls)
    for field in dataclasses.fields(cls):
        object.__setattr__(cfg, field.name, getattr(good, field.name))
    object.__setattr__(cfg, "gossip_impl", BOGUS)
    return cfg


def _forged_cfgs(h=4):
    rgood, good = make_cfgs(h=h)
    return _forged(RefFedDecConfig, rgood), _forged(FedDecConfig, good)


def _forged_plans():
    (r4, c4), (r8, c8) = make_cfgs(), make_cfgs(h=8)
    (rf4, f4), (rf8, f8) = _forged_cfgs(), _forged_cfgs(h=8)
    return (dataclasses.replace(ref_sweep.make_sweep_plan([r4, r8]),
                                gossip_impl=BOGUS, configs=(rf4, rf8)),
            dataclasses.replace(sweep.make_sweep_plan([c4, c8]),
                                gossip_impl=BOGUS, configs=(f4, f8)))


@pytest.fixture(scope="module")
def canonical() -> str:
    msg = str(engine.unknown_gossip_impl(BOGUS))
    assert msg == str(ref_engine.unknown_gossip_impl(BOGUS))
    return msg


def test_canonical_error_names_every_impl(canonical):
    assert engine.GOSSIP_IMPLS == ref_engine.GOSSIP_IMPLS
    for impl in engine.GOSSIP_IMPLS:
        assert impl in canonical
    assert repr(BOGUS) in canonical


def test_config_constructor_uses_canonical_error(canonical):
    _, good = make_cfgs()
    with pytest.raises(ValueError) as e:
        FedDecConfig(mixing=good.mixing, h=good.h, k=good.k,
                     server_enabled=good.server_enabled, gossip_impl=BOGUS,
                     gossip_compress=good.gossip_compress)
    assert str(e.value) == canonical


def test_check_gossip_impl_uses_canonical_error(canonical):
    with pytest.raises(ValueError) as e:
        engine.check_gossip_impl(BOGUS)
    assert str(e.value) == canonical


@pytest.mark.parametrize("layout", ["tree", "flat", "sweep", "sharded"])
def test_resolve_gossip_uses_canonical_error(layout, canonical):
    """The sharded layout is not ported: the port names it so."""
    source = _forged_plans()[1] if layout == "sweep" \
        else _forged_cfgs()[1]
    with pytest.raises(ValueError) as e:
        engine.resolve_gossip(source, layout=layout)
    if layout == "sharded":
        assert "is not ported" in str(e.value)
    else:
        assert str(e.value) == canonical


def test_sweep_plan_builder_uses_canonical_error(canonical):
    _, cfg = _forged_cfgs()
    with pytest.raises(ValueError) as e:
        sweep.make_sweep_plan([cfg, cfg])
    assert str(e.value) == canonical


@pytest.mark.parametrize("entry", ["tree_round", "tree_step", "flat_round",
                                   "flat_step", "sweep_round",
                                   "sharded_round", "engine_round"])
def test_round_makers_use_canonical_error(entry, canonical):
    spec = _port_spec(_ref_spec())
    gfn, lfn = _torch_grad_fn, lambda t: torch.tensor([ETA])
    _, cfg = _forged_cfgs()
    if entry == "sharded_round":
        # the reference's sharded maker raises the canonical error, and so
        # does the port's, on a mesh of one rank
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_agent_mesh
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            with pytest.raises(ValueError) as e:
                engine.make_engine_round(
                    engine.parse_engine_spec(cfg), gfn, lfn, device="cpu",
                    flat_spec=spec, mesh=make_agent_mesh(1, device="cpu"))
        finally:
            dist.destroy_process_group()
        assert str(e.value) == canonical
        return
    with pytest.raises(ValueError) as e:
        if entry == "tree_round":
            feddec.make_feddec_round(cfg, gfn, lfn, device="cpu")
        elif entry == "tree_step":
            feddec.make_feddec_step(cfg, gfn, lfn, device="cpu")
        elif entry == "flat_round":
            flat_lib.make_flat_feddec_round(cfg, spec, gfn, lfn,
                                            device="cpu")
        elif entry == "flat_step":
            flat_lib.make_flat_feddec_step(cfg, spec, gfn, lfn,
                                           device="cpu")
        elif entry == "sweep_round":
            sweep.make_sweep_feddec_round(_forged_plans()[1], spec, gfn,
                                          lfn, device="cpu")
        elif entry == "engine_round":
            espec = dataclasses.replace(
                engine.parse_engine_spec(make_cfgs()[1]), configs=(cfg,))
            engine.make_engine_round(espec, gfn, lfn, device="cpu",
                                     flat_spec=spec)
    assert str(e.value) == canonical


def test_permute_hint_points_at_make_permute_gossip(canonical):
    """'permute' is not a gossip_impl: the error redirects to the
    gossip_fn override, as the reference's does."""
    msg = str(engine.unknown_gossip_impl("permute"))
    assert msg == str(ref_engine.unknown_gossip_impl("permute"))
    assert "make_permute_gossip" in msg
    assert "gossip_fn=" in msg
    assert "make_permute_gossip" not in canonical
