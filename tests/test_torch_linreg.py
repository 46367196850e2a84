"""The port's §4 linear-regression problem, schedules and η against the JAX
package's.

``make_problem`` is the reference's numpy code: the same seed gives the
same instance bit for bit.  The port's ``grad_fn`` (one agent's
``(params, batch) -> (loss, grads)``, the gradient written out) under
``torch.func.vmap`` is held to ``jax.vmap`` of the reference's within
1e-12·max|g| in float64 (other summation orders).  ``paper_diminishing``
and an f64 lattice's per-run η equal the reference's 2/(μ(γ_r + t)) bit
for bit; the f32 schedules within 1e-6 relative (the port rounds an f64
value once, the reference computes in f32).  The convergence tests mirror
tests/test_feddec.py on the port's flat engine with its own randomness.
Float64 runs under ``with jax.enable_x64(True):``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as ref_theory
from repro.data import linreg as ref_linreg
from repro.optim import schedules as ref_schedules
from repro_torch.core import flat as flat_lib, sweep, theory, topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.feddec import FedAvgConfig, FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.optim import schedules

GRAD_TOL = 1e-12        # × max|g|: f64, other summation order
F32_RTOL = 1e-6         # f32 schedules: one rounding against f32 arithmetic

PROBLEMS = [dict(), dict(n=10, seed=0, c_base=1.5),
            dict(n=7, m_rows=4, d=3, seed=11), dict(n=20, seed=5)]


@pytest.mark.parametrize("kw", PROBLEMS, ids=lambda kw: str(kw) or "paper")
def test_make_problem_is_the_reference_bit_for_bit(kw):
    ref = ref_linreg.make_problem(**kw)
    got = linreg.make_problem(**kw)
    for field in ("x", "y", "z_star"):
        assert np.array_equal(getattr(got, field), getattr(ref, field))
    for field in ("f_star", "l_smooth", "mu", "gamma_heterogeneity"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (got.n, got.d, got.m_rows) == (ref.n, ref.d, ref.m_rows)
    z = np.random.default_rng(1).standard_normal(ref.d)
    assert got.global_cost(z) == ref.global_cost(z)
    assert got.local_cost(z, 2) == ref.local_cost(z, 2)


@pytest.mark.parametrize("m", [1, 3, 10])
def test_grad_fn_under_vmap_matches_the_reference(m):
    rng = np.random.default_rng(m)
    rows, d = 12, 25
    z = rng.standard_normal((rows, d)) * 2.0 ** 10
    xb = rng.normal(0.0, 0.25, (rows, m, d))
    yb = rng.standard_normal((rows, m)) * 2.0 ** 20
    with jax.enable_x64(True):
        ref_loss, ref_g = jax.vmap(ref_linreg.make_grad_fn(m),
                                   in_axes=(0, 0, None))(
            jnp.asarray(z), (jnp.asarray(xb), jnp.asarray(yb)), None)
        ref_loss, ref_g = np.asarray(ref_loss), np.asarray(ref_g)
    loss, g = torch.func.vmap(linreg.make_grad_fn(m))(
        {"z": torch.from_numpy(z)},
        {"x": torch.from_numpy(xb), "y": torch.from_numpy(yb)})
    assert g["z"].dtype == loss.dtype == torch.float64
    scale = np.abs(ref_g).max()
    assert np.abs(g["z"].numpy() - ref_g).max() <= GRAD_TOL * scale
    np.testing.assert_allclose(loss.numpy(), ref_loss, rtol=GRAD_TOL)


def test_sample_minibatch_and_suboptimality_match_the_reference():
    ref = ref_linreg.make_problem(seed=2)
    problem = linreg.make_problem(seed=2)
    with jax.enable_x64(True):
        key = jax.random.key(4)
        rxb, ryb = ref_linreg.sample_minibatch(ref, key, m=3)
        idx = jax.random.randint(key, (ref.n, 3), 0, ref.m_rows)
        z = np.random.default_rng(0).standard_normal((ref.n, ref.d))
        ref_sub = float(ref.suboptimality(jnp.asarray(z)))
        ref_cost = float(ref.global_cost_stacked(jnp.asarray(z)))
        rxb, ryb, idx = np.asarray(rxb), np.asarray(ryb), np.array(idx)
    batch = linreg.sample_minibatch(problem, torch.from_numpy(idx))
    assert np.array_equal(batch["x"].numpy(), rxb)
    assert np.array_equal(batch["y"].numpy(), ryb)
    cost = float(problem.global_cost_stacked(torch.from_numpy(z)))
    assert abs(cost - ref_cost) <= 1e-12 * ref_cost
    sub = float(problem.suboptimality(torch.from_numpy(z)))
    assert abs(sub - ref_sub) <= 1e-12 * ref_cost


# ---------------------------------------------------------------------------
# Schedules and η
# ---------------------------------------------------------------------------


def test_paper_diminishing_is_the_reference_bit_for_bit():
    problem = linreg.make_problem()
    gammas = np.asarray([theory.gamma(problem.l_smooth, problem.mu, h)
                         for h in (10, 10, 100, 100, 3)])
    t = np.asarray([1, 2, 77, 5000, 4999])
    got = schedules.paper_diminishing(problem.mu, gammas, device="cpu")(t)
    with jax.enable_x64(True):
        want = np.asarray(ref_schedules.paper_diminishing(
            problem.mu, gammas)(jnp.asarray(t, jnp.int32)))
        scalar = ref_theory.paper_stepsize(problem.mu, gammas[2])(7)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    assert float(theory.paper_stepsize(problem.mu, gammas[2])(7)) == scalar


@pytest.mark.parametrize("name", ["constant", "linear_warmup",
                                  "cosine_decay", "cosine_no_warmup"])
def test_f32_schedules_match_the_reference(name):
    ts = np.asarray([0, 1, 5, 37, 99, 100, 250])
    make = {
        "constant": (lambda m, **kw: m.constant(3e-3, **kw)),
        "linear_warmup": (lambda m, **kw: m.linear_warmup(0.1, 40, **kw)),
        "cosine_decay": (lambda m, **kw: m.cosine_decay(0.1, 200, 20,
                                                        1e-3, **kw)),
        "cosine_no_warmup": (lambda m, **kw: m.cosine_decay(0.1, 200,
                                                            **kw)),
    }[name]
    ref_fn, fn = make(ref_schedules), make(schedules, device="cpu")
    for t in ts:
        got = fn(int(t))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref_fn(jnp.asarray(t))),
                                   rtol=F32_RTOL)
    wide = make(schedules, device="cpu", dtype=torch.float64)(ts)
    assert wide.dtype == torch.float64
    # a constant η ignores t, as the reference's does
    assert wide.shape == (() if name == "constant" else ts.shape)


def _lattice_eta(spec_dtype, lr_fn):
    """metrics['eta'] of one step of a 3-run linreg lattice."""
    problem = linreg.make_problem(n=5, d=4, seed=0)
    graph = topo.ring_graph(5, k=1)
    plan = sweep.make_sweep_plan(
        [FedDecConfig(mixing=MixingDistribution(graph), h=h, k=2)
         for h in (10, 100)] + [FedAvgConfig(5, h=10, k=2)])
    spec = flat_lib.make_flat_spec({"z": torch.zeros(4, dtype=spec_dtype)})
    step = sweep.make_sweep_feddec_step(
        plan, spec, linreg.make_grad_fn(problem.m_rows), lr_fn,
        device="cpu")
    state = sweep.init_sweep_state(plan, spec, {"z": torch.zeros(
        4, dtype=spec_dtype)})
    state.step = np.asarray([1, 5, 9])
    batch = linreg.sample_minibatch(problem, torch.zeros((5, 1), dtype=int))
    batch = {k: v.to(spec_dtype).expand((3,) + v.shape)
             for k, v in batch.items()}
    _, metrics = step(state, batch, _ConstDraws())
    return problem, metrics["eta"]


class _ConstDraws:
    def participants(self, t, n, k):
        return torch.zeros((len(t), k), dtype=torch.int64)


def test_f64_lattice_eta_is_the_reference_stepsize_bit_for_bit():
    """The lattice's per-run η stays f64 and beside the buffer; it was
    a CPU tensor from numpy whatever the buffer's device."""
    problem = linreg.make_problem(n=5, d=4, seed=0)
    gammas = np.asarray([theory.gamma(problem.l_smooth, problem.mu, h)
                         for h in (10, 100, 10)])
    _, eta = _lattice_eta(torch.float64,
                          theory.paper_stepsize(problem.mu, gammas))
    with jax.enable_x64(True):
        want = np.asarray(2.0 / (problem.mu * (
            gammas + jnp.asarray([1, 5, 9], jnp.int32))))
    assert eta.dtype == torch.float64 and eta.device.type == "cpu"
    assert np.array_equal(eta.numpy(), want)


def test_f32_trainer_eta_is_unchanged():
    """The CLI's lr_fn: one (1,) f32 tensor, expanded over the runs with
    its bits and dtype kept."""
    lr = torch.full((1,), 3e-3, dtype=torch.float32)
    _, eta = _lattice_eta(torch.float32, lambda t: lr)
    assert eta.dtype == torch.float32
    assert torch.equal(eta, lr.expand(3))


# ---------------------------------------------------------------------------
# Convergence on the port's flat engine (tests/test_feddec.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    # smaller heterogeneity factor keeps float32 happy in tests
    return linreg.make_problem(n=10, seed=0, c_base=1.5)


def _setup(problem, h=10, k=2, r=0.6, p_fail=0.0, server=True):
    g = topo.geographic_graph(problem.n, r, seed=3)
    md = MixingDistribution(g, p_fail=p_fail,
                            scheme="metropolis" if p_fail else "laplacian")
    cfg = FedDecConfig(mixing=md, h=h, k=k, server_enabled=server)
    gam = theory.gamma(problem.l_smooth, problem.mu, h)
    return cfg, schedules.paper_diminishing(problem.mu, gam,
                                            dtype=torch.float32,
                                            device="cpu")


def _run(cfg, lr, problem, t_steps, seed=0):
    spec = flat_lib.make_flat_spec({"z": torch.zeros(problem.d)})
    step = flat_lib.make_flat_feddec_step(
        cfg, spec, linreg.make_grad_fn(problem.m_rows), lr, device="cpu")
    state = flat_lib.init_flat_state(spec, {"z": torch.zeros(problem.d)},
                                     problem.n)
    draws = Draws(seed, "cpu")
    metrics = None
    for _ in range(t_steps):
        idx = torch.randint(0, problem.m_rows, (problem.n, 1),
                            generator=draws.generator)
        batch = linreg.sample_minibatch(problem, idx, dtype=torch.float32)
        state, metrics = step(state, batch, draws)
    return state, metrics


def _subopt(problem, flat):
    return float(problem.suboptimality(flat.double()))


class TestFedDecStep:
    def test_state_shapes_and_finite(self, problem):
        cfg, lr = _setup(problem)
        state, metrics = _run(cfg, lr, problem, 5)
        assert state.flat.shape == (problem.n, problem.d)
        assert state.step == 6
        assert torch.isfinite(state.flat).all()
        assert np.isfinite(float(metrics["loss"]))

    def test_stepsize_schedule(self, problem):
        _, lr = _setup(problem, h=10)
        gam = theory.gamma(problem.l_smooth, problem.mu, 10)
        assert float(lr(1)) == pytest.approx(2 / (problem.mu * (gam + 1)))
        assert float(lr(100)) < float(lr(1))
        # feasibility conditions used in the proof
        assert float(lr(1)) <= 1 / (4 * problem.l_smooth) + 1e-9
        assert float(lr(1)) <= 2 * float(lr(1 + 10)) + 1e-9

    def test_server_round_consensus(self, problem):
        """Right after t+1 ∈ ℋ all agents hold the same parameters."""
        cfg, lr = _setup(problem, h=5)
        state, _ = _run(cfg, lr, problem, 4)  # t: 1→5, server at t+1=5
        p = state.flat.numpy()
        np.testing.assert_allclose(p, np.broadcast_to(p[:1], p.shape),
                                   atol=1e-5)

    def test_no_consensus_between_rounds(self, problem):
        cfg, lr = _setup(problem, h=100)
        state, _ = _run(cfg, lr, problem, 6)
        p = state.flat.numpy()
        assert not np.allclose(p[0], p[1], atol=1e-8)  # heterogeneous data

    def test_server_disabled(self, problem):
        cfg, lr = _setup(problem, h=5, server=False)
        state, _ = _run(cfg, lr, problem, 10)
        assert torch.isfinite(state.flat).all()


class TestConvergence:
    def test_feddec_converges(self, problem):
        cfg, lr = _setup(problem)
        sub0 = _subopt(problem, torch.zeros(problem.n, problem.d))
        state, _ = _run(cfg, lr, problem, 800)
        assert _subopt(problem, state.flat) < 0.05 * sub0

    def test_feddec_beats_fedavg_large_h(self, problem):
        """The paper's headline claim, H large ⇒ FedDec ≫ FedAvg (Fig. 4)."""
        h = 50
        cfg, lr = _setup(problem, h=h)
        sd, _ = _run(cfg, lr, problem, 600, seed=1)
        sa, _ = _run(FedAvgConfig(problem.n, h=h, k=2), lr, problem, 600,
                     seed=1)
        assert _subopt(problem, sd.flat) < _subopt(problem, sa.flat)

    def test_link_failures_still_converge(self, problem):
        cfg, lr = _setup(problem, p_fail=0.5)
        sub0 = _subopt(problem, torch.zeros(problem.n, problem.d))
        state, _ = _run(cfg, lr, problem, 800)
        assert _subopt(problem, state.flat) < 0.1 * sub0
