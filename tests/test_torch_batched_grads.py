"""Algorithm 1's line 4 as one batched pass: the port's ``flat.grads_of``
(``torch.func.vmap`` of one agent's GradFn over every row of the (rows, D)
buffer) against the reference's ``jax.vmap(grad_fn)`` over the same rows
(repro/core/flat.py:403-408, repro/core/sweep.py:335-344).

Inputs are numpy arrays from a seed: the reference model's initial row,
perturbed row by row so that no two agents agree, and one token batch per
row.  The reference's weights cross over through the buffer itself (the
port's FlatSpec is the reference's column for column).  JAX stays on the
CPU, and the port runs its plain versions.

Tolerances (f32, other summation orders): the tiny LM 1e-5·max|g|, the
recurrent smoke configs 1e-4·max|g| (PERF.md §2's per-model bound), the
per-row ``torch.autograd.grad`` loop the engines ran before 1e-6·max|g|,
losses relative 1e-5; the analytic linreg GradFn through both engines
1e-5·max|x| on the buffers.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.models import build_model as ref_build_model
from repro_torch.core import engine, flat as flat_lib, sweep
from repro_torch.core.draws import Draws, SweepDraws
from repro_torch.models import build_model
from test_torch_gpu import _per_row_grads
from test_torch_sweep import H, N, ReplayDraws, ReplaySweepDraws, _cfg
from test_torch_zoo import _configs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODELS = ["tiny", "recurrentgemma-9b", "mamba2-2.7b"]
MODEL_TOL = {"tiny": 1e-5, "recurrentgemma-9b": 1e-4, "mamba2-2.7b": 1e-4}
LOOP_TOL = 1e-6
LOSS_RTOL = 1e-5
ROWS, SEQ = 4, 32
R_RUNS, N_LATTICE = 2, 3


def _rows(name, rows, seed=0):
    """(reference model, port model, reference spec, port spec, the
    (rows, D) buffer, the reference's batch, the port's batch)."""
    ref_cfg, cfg = _configs(name)
    ref_model = ref_build_model(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.key(seed))
    ref_spec = ref_flat.make_flat_spec(params)
    spec = flat_lib.make_flat_spec(flat_lib.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    assert spec.d == ref_spec.d and spec.offsets == ref_spec.offsets
    rng = np.random.default_rng(seed + 1)
    row = np.asarray(ref_spec.ravel(params), np.float32)
    flat = row + 0.02 * rng.standard_normal((rows, row.size)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(rows, 2, SEQ))
    positions = np.broadcast_to(np.arange(SEQ), (rows, 2, SEQ))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "positions": jnp.asarray(positions, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
              "positions": torch.from_numpy(
                  np.ascontiguousarray(positions).astype(np.int64))}
    return (ref_model, build_model(cfg), ref_spec, spec, flat, jbatch,
            tbatch)


def _ref_vmapped(ref_model, ref_spec, flat, jbatch):
    """The reference's line 4: jax.vmap(grad_fn) over the rows' tree
    view, the gradient tree flattened back to (rows, D)."""
    def batched(buf, batch):
        keys = jax.random.split(jax.random.key(0), buf.shape[0])
        losses, grads = jax.vmap(ref_model.grad_fn())(
            ref_spec.unflatten(buf), batch, keys)
        return losses, ref_spec.flatten(grads)

    losses, g = jax.jit(batched)(jnp.asarray(flat), jbatch)
    return np.asarray(losses), np.asarray(g)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.max(np.abs(got - want)), np.max(np.abs(want))
    assert err <= tol * scale, (err, scale)


def _losses_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# The batched gradient of the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_batched_grads_match_reference_vmap(name):
    ref_model, model, ref_spec, spec, flat, jbatch, tbatch = _rows(name,
                                                                   ROWS)
    want_l, want_g = _ref_vmapped(ref_model, ref_spec, flat, jbatch)
    losses, g = flat_lib.grads_of(spec, model.grad_fn(),
                                  torch.from_numpy(flat), tbatch)
    assert g.shape == (ROWS, spec.d) and g.dtype == torch.float32
    _losses_close(losses, want_l)
    _close(g, want_g, MODEL_TOL[name])


@pytest.mark.parametrize("name", MODELS)
def test_batched_grads_match_the_per_row_loop(name):
    _, model, _, spec, flat, _, tbatch = _rows(name, ROWS)
    buf = torch.from_numpy(flat)
    losses, g = flat_lib.grads_of(spec, model.grad_fn(), buf, tbatch)
    want_l, want_g = _per_row_grads(spec, model.loss, buf, tbatch)
    _losses_close(losses, want_l)
    _close(g, want_g, LOOP_TOL)


def test_lattice_rows_match_reference():
    """The lattice's R·n rows in one call, against the reference's
    lattice form: (R, n, D) → (R·n, D) → vmap → (R, n, D)."""
    rows = R_RUNS * N_LATTICE
    ref_model, model, ref_spec, spec, flat, jbatch, tbatch = _rows("tiny",
                                                                   rows)
    want_l, want_g = _ref_vmapped(ref_model, ref_spec, flat, jbatch)
    lattice = torch.from_numpy(flat).view(R_RUNS, N_LATTICE, spec.d)
    batch3 = {k: v.view((R_RUNS, N_LATTICE) + v.shape[1:])
              for k, v in tbatch.items()}
    losses, g = sweep.grads_of_lattice(spec, model.grad_fn(), lattice,
                                       batch3)
    assert losses.shape == (R_RUNS, N_LATTICE)
    assert g.shape == (R_RUNS, N_LATTICE, spec.d)
    _losses_close(losses.reshape(-1), want_l)
    _close(g.reshape(rows, spec.d), want_g, MODEL_TOL["tiny"])
    # each run's slice against the flat engine's call on its n rows
    for r in range(R_RUNS):
        lr, gr = flat_lib.grads_of(spec, model.grad_fn(), lattice[r],
                                   {k: v[r] for k, v in batch3.items()})
        _losses_close(losses[r], lr)
        _close(g[r], gr, LOOP_TOL)


# ---------------------------------------------------------------------------
# An analytic GradFn through both engines (repro/data/linreg.py's form)
# ---------------------------------------------------------------------------

LIN_D, LIN_M, LIN_ETA = 16, 8, 0.05


def _ref_linreg(params, batch, key):
    del key
    r = batch["x"] @ params["z"] - batch["y"]
    return jnp.mean(r ** 2), {"z": 2.0 * batch["x"].T @ r
                              / batch["x"].shape[0]}


def _linreg(params, batch):
    """Loss mean((Xz − y)²) and its gradient 2Xᵀ(Xz − y)/m, written out:
    no autograd inside."""
    r = batch["x"] @ params["z"] - batch["y"]
    return torch.mean(r ** 2), {"z": 2.0 * batch["x"].T @ r
                                / batch["x"].shape[0]}


def _linreg_data(lead: tuple, seed=5):
    rng = np.random.default_rng(seed)
    flat0 = rng.standard_normal(lead + (LIN_D,)).astype(np.float32)
    x = (rng.standard_normal((H,) + lead + (LIN_M, LIN_D)) / 4).astype(
        np.float32)
    y = rng.standard_normal((H,) + lead + (LIN_M,)).astype(np.float32)
    return flat0, {"x": x, "y": y}


def _lin_specs():
    ref_spec = ref_flat.make_flat_spec(
        {"z": jax.ShapeDtypeStruct((LIN_D,), jnp.float32)})
    return ref_spec, flat_lib.make_flat_spec({"z": torch.zeros(LIN_D)})


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_analytic_grad_fn_through_the_flat_engine(impl, fused):
    rcfg, cfg = _cfg("ring2", impl)
    ref_spec, spec = _lin_specs()
    flat0, batches = _linreg_data((N,))
    round_ref = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, _ref_linreg,
        lambda t: jnp.asarray(LIN_ETA, jnp.float32), donate=False,
        fuse_update_mix=fused)
    key = jax.random.key(11)
    rstate, rmet = round_ref(
        ref_flat.FlatFedState(flat=jnp.asarray(flat0),
                              step=jnp.asarray(1, jnp.int32)),
        jax.tree.map(jnp.asarray, batches), key)
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, _linreg, lambda t: torch.tensor([LIN_ETA]), device="cpu",
        fuse_update_mix=fused)
    state, met = round_fn(
        flat_lib.flat_state_from_numpy(flat0, 1),
        {k: torch.from_numpy(v) for k, v in batches.items()},
        ReplayDraws(key))
    assert state.step == int(rstate.step) == H + 1
    _close(state.flat, rstate.flat, 1e-5)
    _losses_close(met["loss"], rmet["loss"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_analytic_grad_fn_through_the_sweep_engine(impl, fused):
    pairs = [_cfg("ring2", impl), _cfg("ring1", impl, h=2)]
    ref_cfgs, cfgs = zip(*pairs)
    ref_spec, spec = _lin_specs()
    flat0, batches = _linreg_data((len(pairs), N))
    round_ref = ref_sweep.make_sweep_feddec_round(
        ref_sweep.make_sweep_plan(ref_cfgs), ref_spec, _ref_linreg,
        lambda t: jnp.asarray(LIN_ETA, jnp.float32), donate=False,
        fuse_update_mix=fused)
    run_keys = jax.random.split(jax.random.key(13), len(pairs))
    rstate, rmet = round_ref(
        ref_sweep.SweepFedState(flat=jnp.asarray(flat0),
                                step=jnp.ones((len(pairs),), jnp.int32)),
        jax.tree.map(jnp.asarray, batches), run_keys)
    round_fn = sweep.make_sweep_feddec_round(
        sweep.make_sweep_plan(cfgs), spec, _linreg,
        lambda t: torch.tensor([LIN_ETA]), device="cpu",
        fuse_update_mix=fused)
    state, met = round_fn(
        sweep.SweepFedState(flat=torch.from_numpy(flat0.copy()),
                            step=np.ones(len(pairs), np.int64)),
        {k: torch.from_numpy(v) for k, v in batches.items()},
        ReplaySweepDraws(run_keys))
    np.testing.assert_array_equal(state.step, np.asarray(rstate.step))
    _close(state.flat, rstate.flat, 1e-5)
    _losses_close(met["loss"], rmet["loss"])


# ---------------------------------------------------------------------------
# No per-row loop: one call, no vmap fallback, no loss in place of a GradFn
# ---------------------------------------------------------------------------


@pytest.fixture
def no_fallback():
    """vmap's per-sample fallback warns once that is turned on: make the
    warning an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_the_fallback_guard_catches_a_fallback(no_fallback):
    """torch.histc has no batching rule: the guard must stop it."""
    with pytest.raises(UserWarning, match="batching rule for aten::histc"):
        torch.func.vmap(torch.histc)(torch.randn(3, 8))


@pytest.mark.parametrize("name", MODELS)
def test_no_op_falls_back_to_a_per_row_loop(name, no_fallback):
    _, model, _, spec, flat, _, tbatch = _rows(name, 2)
    losses, g = flat_lib.grads_of(spec, model.grad_fn(),
                                  torch.from_numpy(flat), tbatch)
    assert torch.isfinite(g).all() and losses.shape == (2,)


class _Counted:
    """A GradFn that counts its calls (vmap calls it once per batch)."""

    def __init__(self, grad_fn):
        self.grad_fn, self.calls = grad_fn, 0

    def __call__(self, params, batch):
        self.calls += 1
        return self.grad_fn(params, batch)


def test_the_engines_call_the_grad_fn_once_a_step():
    _, cfg = _cfg("ring2", "dense")
    _, spec = _lin_specs()
    flat0, batches = _linreg_data((2, N))
    counted = _Counted(_linreg)
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, counted, lambda t: torch.tensor([LIN_ETA]), device="cpu")
    round_fn(flat_lib.flat_state_from_numpy(flat0[0], 1),
             {k: torch.from_numpy(v[:, 0]) for k, v in batches.items()},
             Draws(0, "cpu"))
    assert counted.calls == H
    counted.calls = 0
    round_fn = sweep.make_sweep_feddec_round(
        sweep.make_sweep_plan([cfg, cfg]), spec, counted,
        lambda t: torch.tensor([LIN_ETA]), device="cpu")
    round_fn(sweep.SweepFedState(flat=torch.from_numpy(flat0),
                                 step=np.ones(2, np.int64)),
             {k: torch.from_numpy(v) for k, v in batches.items()},
             SweepDraws(0, "cpu", 2, per_run=False))
    assert counted.calls == H


def test_a_loss_in_place_of_a_grad_fn_is_refused():
    _, spec = _lin_specs()
    with pytest.raises(TypeError, match="value_and_grad"):
        flat_lib.grads_of(spec, lambda p, b: (p["z"] ** 2).sum(),
                          torch.ones(3, LIN_D), {"x": torch.zeros(3, 1)})
    loss, grads = engine.value_and_grad(lambda p, b: (p["z"] ** 2).sum())(
        {"z": torch.ones(LIN_D)}, {})
    assert float(loss) == LIN_D and torch.equal(grads["z"],
                                                torch.full((LIN_D,), 2.0))


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_the_batched_op_count_does_not_grow_with_the_rows():
    """One call issues the same ops for 2 agent rows as for 8: nothing
    loops over the rows (the per-row loop issues 4× its 2-row count)."""
    counts = {}
    for rows in (2, 8):
        _, model, _, spec, flat, _, tbatch = _rows("tiny", rows)
        with _OpCount() as batched:
            flat_lib.grads_of(spec, model.grad_fn(), torch.from_numpy(flat),
                              tbatch)
        with _OpCount() as loop:
            _per_row_grads(spec, model.loss, torch.from_numpy(flat), tbatch)
        counts[rows] = batched.ops, loop.ops
    assert counts[2][0] == counts[8][0]
    assert counts[8][1] > 3.5 * counts[2][1]
    assert counts[8][0] < counts[8][1] / 4


def test_the_first_batched_call_frees_its_buffers_without_the_gc():
    """torch.func's first call imports torch._dynamo, whose import leaves
    reference cycles holding the frames on the stack; the port imports it
    beforehand, so the first step's buffers go when their last reference
    does, not at the next garbage collection.  A fresh process, the
    collector off."""
    code = (
        "import gc, torch\n"
        "from torch.multiprocessing.reductions import StorageWeakRef\n"
        "from repro_torch.core import engine, flat as flat_lib\n"
        "gc.disable()\n"
        "spec = flat_lib.make_flat_spec({'w': torch.zeros(64)})\n"
        "grad_fn = engine.value_and_grad(\n"
        "    lambda p, b: (p['w'] * b['x']).pow(2).sum())\n"
        "flat = torch.randn(4, 64)\n"
        "refs = [StorageWeakRef(flat.untyped_storage())]\n"
        "losses, g = flat_lib.grads_of(spec, grad_fn, flat,\n"
        "                              {'x': torch.randn(4, 64)})\n"
        "refs.append(StorageWeakRef(g.untyped_storage()))\n"
        "del flat, losses, g\n"
        "print([r.expired() for r in refs])\n")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["[True,", "True]"]


def test_the_backward_runs_on_the_calling_thread():
    """grads_of turns autograd's device threads off for its call (their
    frees interleaved with the caller's allocations made the peak vary
    between identical steps on the card) and back on after it."""
    seen = []

    def grad_fn(params, batch):
        seen.append(torch.autograd.is_multithreading_enabled())
        return _linreg(params, batch)

    _, spec = _lin_specs()
    flat0, batches = _linreg_data((N,))
    assert torch.autograd.is_multithreading_enabled()
    flat_lib.grads_of(spec, grad_fn, torch.from_numpy(flat0),
                      {k: torch.from_numpy(v[0]) for k, v in batches.items()})
    assert seen == [False] and torch.autograd.is_multithreading_enabled()
