"""The port's optimizers against the JAX package's (repro/optim).

adamw, sgd, momentum and nesterov on a nested dict and on a bare tensor,
several steps from the same numpy start with the same gradients: the
parameters, the f32 slots and adamw's int32 count within 1e-6 relative
(f32; the two frameworks may round a division or a power one ulp apart).
``clip_by_global_norm`` on both, above and below the threshold.  On a
tensor, sgd and momentum stay bit for bit the plain step that the fused
update+mix kernels #3/#4 reproduce (kernels/ref.py:local_step).  adamw
on the sweep lattice (per-run count and η, one run frozen at its budget)
against the reference's lattice under replayed draws, 1e-5 max abs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import sweep as ref_sweep
from repro_torch import optim
from repro_torch.core import sweep
from repro_torch.kernels import ref as kernel_ref
from repro_torch.tree import leaves
from test_torch_sweep import (ETA, N, ReplaySweepDraws, _cfg, _port_spec,
                              _ref_grad_fn, _ref_spec, _rounds,
                              _torch_grad_fn)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-6
SHAPES = {"emb": (7, 5), "blk": {"w": (5, 3), "b": (3,)}, "s": (1,)}


def _tree(rng, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(np.float32)


def _pair(tree):
    """(jax tree, torch tree) of a numpy tree (a dict or an array)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


def _close(port, ref, rtol=RTOL):
    port_leaves, ref_leaves = leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r)
        assert p.dtype == torch.from_numpy(np.array(r)).dtype
        np.testing.assert_allclose(p.numpy(), r, rtol=rtol,
                                   atol=rtol * max(np.abs(r).max(), 1e-30))


OPTS = {
    "sgd": (ref_optim.sgd, optim.sgd, {}),
    "momentum": (ref_optim.momentum_sgd, optim.momentum_sgd, {}),
    "nesterov": (ref_optim.momentum_sgd, optim.momentum_sgd,
                 {"nesterov": True}),
    "adamw": (ref_optim.adamw, optim.adamw, {}),
    "adamw-decay": (ref_optim.adamw, optim.adamw,
                    {"weight_decay": 0.01, "b2": 0.999}),
}


@pytest.mark.parametrize("layout", ["dict", "tensor"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name, layout):
    make_ref, make_port, kw = OPTS[name]
    ref_opt, opt = make_ref(**kw), make_port(**kw)
    assert opt.kind == ref_opt.kind and opt.hyper == ref_opt.hyper
    rng = np.random.default_rng(3)
    shapes = SHAPES if layout == "dict" else (4, 33)
    ref_p, p = _pair(_tree(rng, shapes))
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    lr = 0.05
    for _ in range(4):
        ref_g, g = _pair(_tree(rng, shapes))
        ref_p, ref_s = ref_opt.update(ref_p, ref_g, ref_s,
                                      jnp.asarray(lr, jnp.float32))
        p, s = opt.update(p, g, s, torch.tensor(lr))
    _close(p, ref_p)
    if name.startswith("adamw"):
        assert s["count"].dtype == torch.int32 and int(s["count"]) == 4
        _close(s["m"], ref_s["m"])
        _close(s["v"], ref_s["v"])
    elif name != "sgd":
        _close(s, ref_s)


@pytest.mark.parametrize("nesterov", [None, False, True])
def test_sgd_and_momentum_on_a_tensor_are_the_kernels_plain_step(nesterov):
    """The flat engine's unfused update equals kernels #3/#4's plain
    local step bit for bit, so fusing the update changes nothing."""
    rng = np.random.default_rng(5)
    x, g, m = (torch.from_numpy(rng.standard_normal((3, 257)).astype(
        np.float32)) for _ in range(3))
    eta = torch.tensor([0.07])
    if nesterov is None:
        got, _ = optim.sgd().update(x, g, (), eta)
        want, _ = kernel_ref.local_step(x, g, None, eta, None, False)
        assert torch.equal(got, want)
        return
    got, got_m = optim.momentum_sgd(nesterov=nesterov).update(x, g, m, eta)
    want, want_m = kernel_ref.local_step(x, g, m, eta, 0.9, nesterov)
    assert torch.equal(got, want) and torch.equal(got_m, want_m)


@pytest.mark.parametrize("layout", ["dict", "tensor"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(layout, max_norm):
    rng = np.random.default_rng(8)
    ref_g, g = _pair(_tree(rng, SHAPES if layout == "dict" else (6, 9)))
    got = optim.clip_by_global_norm(g, max_norm)
    _close(got, ref_optim.clip_by_global_norm(ref_g, max_norm))
    norm = torch.sqrt(sum(torch.sum(v ** 2) for v in leaves(got)))
    if max_norm < 1:
        assert norm == pytest.approx(max_norm, rel=1e-5)
    else:
        for a, b in zip(leaves(got), leaves(g)):
            assert torch.equal(a, b)


def test_adamw_init_slots():
    p = {"a": torch.zeros(2, 3, dtype=torch.float64), "b": torch.zeros(4)}
    s = optim.adamw().init(p)
    assert set(s) == {"m", "v", "count"} and s["count"].shape == ()
    assert all(v.dtype == torch.float32 for v in leaves(s["m"]))
    assert [v.shape for v in leaves(s["v"])] == [(2, 3), (4,)]


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_sweep_lattice_adamw_matches_reference(impl):
    """Two runs with different H, adamw on the lattice's unfused path (the
    flag falls back as the reference's does): each run's count and η, and
    run 0 frozen at its budget of 4 steps, slots and count included."""
    pairs = [_cfg("ring1", impl, h=3), _cfg("ring2", impl, h=2)]
    ref_cfgs, cfgs = zip(*pairs)
    t_steps = np.array([4, 6])
    ref_spec = _ref_spec()
    rng = np.random.default_rng(42)
    flat0 = rng.standard_normal((2, N, ref_spec.d)).astype(np.float32)

    ref_opt, opt = ref_optim.adamw(), optim.adamw()
    ref_plan = ref_sweep.make_sweep_plan(ref_cfgs, t_steps=t_steps)
    rstate = ref_sweep.SweepFedState(
        flat=jnp.asarray(flat0), step=jnp.ones((2,), jnp.int32),
        opt_state=jax.vmap(ref_opt.init)(jnp.asarray(flat0)))
    round_ref = ref_sweep.make_sweep_feddec_round(
        ref_plan, ref_spec, _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=True)

    plan = sweep.make_sweep_plan(cfgs, t_steps=t_steps)
    flat = torch.from_numpy(flat0.copy())
    state = sweep.SweepFedState(
        flat=flat, step=np.ones(2, np.int64),
        opt_state=jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                               dict(jax.vmap(ref_opt.init)(
                                   jnp.asarray(flat0)))))
    eta = torch.tensor([ETA])
    round_fn = sweep.make_sweep_feddec_round(
        plan, _port_spec(ref_spec), _torch_grad_fn, lambda t: eta,
        device="cpu", optimizer=opt, fuse_update_mix=True)

    run_keys = jax.random.split(jax.random.key(11), 2)
    draws = ReplaySweepDraws(run_keys)
    for batches in _rounds(2, rounds=2):
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, batches),
                                 run_keys)
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in batches.items()}, draws)
        np.testing.assert_allclose(met["loss"].numpy(),
                                   np.asarray(rmet["loss"]), rtol=1e-5)
    assert state.opt_state["count"].tolist() == [4, 6]
    np.testing.assert_array_equal(np.asarray(rstate.opt_state["count"]),
                                  [4, 6])
    for port, ref in ((state.flat, rstate.flat),
                      (state.opt_state["m"], rstate.opt_state["m"]),
                      (state.opt_state["v"], rstate.opt_state["v"])):
        assert np.max(np.abs(port.numpy() - np.asarray(ref))) <= 1e-5


def test_sweep_init_state_gives_each_run_its_own_adamw_slots():
    plan = sweep.make_sweep_plan([_cfg("ring1")[1], _cfg("ring2")[1]])
    spec = _port_spec(_ref_spec())
    params = spec.unravel(torch.zeros(spec.d))
    state = sweep.init_sweep_state(plan, spec, params,
                                   optimizer=optim.adamw())
    assert state.opt_state["count"].shape == (2,)
    assert state.opt_state["m"].shape == state.flat.shape
    assert all(v.is_contiguous() for v in leaves(state.opt_state))
    one = sweep.slice_run(state, 1)
    assert one.opt_state["count"].shape == ()
