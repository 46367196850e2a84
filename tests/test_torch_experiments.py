"""The paper's §4 experiments on the port's float64 sweep lattice, against
the JAX package's figure drivers under replayed randomness.

The reference's drivers re-key every run at each of its server rounds
(``per_step_keys``: step s of run r folds ``keys[s, r]`` with the carried
counter t, repro/core/sweep.py:330-333).  :class:`ReplayStepKeyDraws`
extends the sweep replay harness (``ReplaySweepDraws``) with that (T, R)
table of step keys; the participants of the whole horizon come from one
vmapped call, the minibatch rows from the reference's own
``lattice_minibatch_indices``.  Under it the port's fig4 lattice (both
graphs, H 10 and 100, FedDec and FedAvg, as ``_lattice`` builds it) and
theory_check's R = 1 trajectory are held to the reference's drivers,
rebuilt here from the reference's modules because the drivers switch x64
on globally: the iterates within 1e-10·max|z|, the suboptimality within
1e-9·f(z̄) (f(z̄) − f* cancels near the optimum, so a bound relative to
the difference means nothing).  The port's own draws (core/draws.py:
RoundDraws) are checked for their structure, and every driver is run at
the paper's settings on the CPU with its own randomness, where each must
pass all its checks.  Everything float64 runs under ``with
jax.enable_x64(True):``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as ref_common
from benchmarks import fig4_convergence as ref_fig4
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.core import theory as ref_theory
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.data import linreg as ref_linreg
from repro_torch.core import flat as flat_lib, sweep, topology as topo
from repro_torch.core.draws import RoundDraws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.experiments import ablation_server, common, fig2_alpha, \
    fig4_convergence, table1_lambda2, theory_check
from test_torch_sweep import ReplaySweepDraws

Z_TOL = 1e-10           # × max|z|: the iterates, f64 over a short horizon
SUB_TOL = 1e-9          # × f(z̄): the suboptimality f(z̄) − f*
T_REPLAY = 200          # a multiple of both H; the reference takes ~1 s


class ReplayStepKeyDraws(ReplaySweepDraws):
    """The reference lattice's draws under ``per_step_keys``: step t of run
    r (t from 1) uses ``split(fold_in(step_keys[t − 1, r], t), 3)``.  The
    (T, R, K) participants are drawn at construction, in one vmapped call,
    and ``minibatch`` is the reference's (T, R, n, m) row table.  Build it
    under the x64 setting of the reference run it replays (randint's width
    follows it)."""

    def __init__(self, step_keys, n, k, minibatch=None):
        super().__init__(None)
        self.step_keys = step_keys
        t = jnp.arange(1, step_keys.shape[0] + 1)
        draw = jax.jit(jax.vmap(jax.vmap(
            lambda key, tt: jax.random.randint(jax.random.split(
                jax.random.fold_in(key, tt), 3)[2], (k,), 0, n),
            in_axes=(0, None))))
        self._participants = np.array(draw(step_keys, t)).astype(np.int64)
        self._minibatch = minibatch

    def _key(self, r, t, which):
        s = int(t[r])
        return jax.random.split(jax.random.fold_in(
            self.step_keys[s - 1, r], s), 3)[which]

    def participants(self, t, n, k):
        s = np.asarray(t, dtype=np.int64) - 1
        return torch.from_numpy(self._participants[s, np.arange(len(s))])

    def minibatch_indices(self, m_batch, m_rows):
        idx = np.array(self._minibatch, dtype=np.int64)
        assert idx.shape[-1] == m_batch and idx.max() < m_rows
        return torch.from_numpy(idx)


# ---------------------------------------------------------------------------
# The port's own per-round draws
# ---------------------------------------------------------------------------


def _rd(seed_ids, h, t_steps=40, **kw):
    return RoundDraws(5, seed_ids, h, t_steps, n=6, k=2, device="cpu", **kw)


def test_round_draws_share_by_seed_and_h():
    d = _rd([0, 1, 0, 0], [10, 10, 10, 4], link_failures=True)
    idx = d.minibatch_indices(2, 9)
    assert idx.shape == (40, 4, 6, 2) and idx.dtype == torch.int64
    assert 0 <= int(idx.min()) and int(idx.max()) < 9
    for t in (1, 10, 11, 40):
        tt = np.full(4, t)
        p, u = d.participants(tt, 6, 2), d.link_uniforms(tt, 6)
        assert p.shape == (4, 2) and u.shape == (4, 6, 6)
        assert torch.equal(p[0], p[2]) and torch.equal(u[0], u[2])
        assert not torch.equal(u[0], u[1])
        # H = 4 and H = 10 share round 0's stream (t ≤ 4), then part
        assert torch.equal(u[0], u[3]) == (t <= 4)
    assert torch.equal(idx[:, 0], idx[:, 2])
    assert not torch.equal(idx[:, 0], idx[:, 1])


def test_round_draws_of_a_run_depend_on_nothing_else():
    """Run r's draws depend on (seed, its seed id, its H) only: not on the
    other runs, nor on the horizon (a prefix of a longer one), and a
    second object on the same seed draws the same."""
    d = _rd([0, 1, 2], [10, 10, 100], t_steps=40)
    alone = _rd([2], [100], t_steps=60)
    assert torch.equal(d.minibatch_indices(1, 9)[:, 2],
                       alone.minibatch_indices(1, 9)[:40, 0])
    for t in (1, 17, 40):
        assert torch.equal(d.participants(np.full(3, t), 6, 2)[2],
                           alone.participants([t], 6, 2)[0])
    again = _rd([0, 1, 2], [10, 10, 100], t_steps=40)
    assert torch.equal(again.minibatch_indices(1, 9),
                       d.minibatch_indices(1, 9))


def test_round_draws_rekey_at_each_round():
    """Round j of a run is its own stream: steps of round 1 under H = 5
    are not those of round 0, and H = 5 and H = 10 begin alike."""
    d = _rd([0, 0], [5, 10], t_steps=20)
    idx = d.minibatch_indices(1, 1000)
    assert torch.equal(idx[:5, 0], idx[:5, 1])
    assert not torch.equal(idx[5:10, 0], idx[5:10, 1])


def test_round_draws_index_each_run_by_its_own_step():
    d = _rd([0, 1], [4, 4], t_steps=8)
    both = d.participants(np.asarray([2, 7]), 6, 2)
    assert torch.equal(both[0], d.participants(np.full(2, 2), 6, 2)[0])
    assert torch.equal(both[1], d.participants(np.full(2, 7), 6, 2)[1])


def test_round_draws_refuse_what_they_were_not_made_for():
    d = _rd([0], [4])
    with pytest.raises(ValueError, match="n=6, K=2"):
        d.participants([1], 7, 2)
    with pytest.raises(ValueError, match="without link_failures"):
        d.link_uniforms([1], 6)
    with pytest.raises(ValueError, match="one entry per run"):
        RoundDraws(0, [0, 1], [4], 8, n=6, k=2, device="cpu")


def test_sweep_round_refuses_per_step_keys_and_names_round_draws():
    plan = sweep.make_sweep_plan([FedDecConfig(
        mixing=MixingDistribution(topo.ring_graph(4)))])
    spec = flat_lib.make_flat_spec({"z": torch.zeros(3)})
    with pytest.raises(ValueError, match="RoundDraws"):
        sweep.make_sweep_feddec_round(plan, spec, linreg.make_grad_fn(1),
                                      lambda t: torch.ones(1),
                                      device="cpu", per_step_keys=True)


def _small_lattice(p_fail=0.2):
    """Two linreg runs on 8 agents: H 4 and 3, one run failing links."""
    graphs = (ref_topo.geographic_graph(8, 0.6, seed=3),
              ref_topo.geographic_graph(8, 0.6, seed=7))
    ref_cfgs, cfgs = [], []
    for g, h, p in zip(graphs, (4, 3), (0.0, p_fail)):
        ref_cfgs.append(RefFedDecConfig(mixing=RefMixing(
            g, p_fail=p, scheme="metropolis", dtype=jnp.float64), h=h, k=2))
        cfgs.append(FedDecConfig(mixing=MixingDistribution(
            topo.Graph(g.adjacency), p_fail=p, scheme="metropolis",
            dtype=torch.float64), h=h, k=2))
    return ref_cfgs, cfgs


def _port_lattice(cfgs, problem, draws, idx):
    """T steps of the port's lattice from 0 with the given rows."""
    plan = sweep.make_sweep_plan(cfgs)
    spec = flat_lib.make_flat_spec({"z": torch.zeros(problem.d,
                                                     dtype=torch.float64)})
    step = sweep.make_sweep_feddec_step(
        plan, spec, linreg.make_grad_fn(problem.m_rows),
        common.paper_lr_fn(problem, 4), device="cpu")
    state = sweep.init_sweep_state(plan, spec, {"z": torch.zeros(
        problem.d, dtype=torch.float64)})
    gather = common.sweep_minibatch_gather(problem, "cpu")
    for s in range(idx.shape[0]):
        state, _ = step(state, gather(torch.from_numpy(idx[s])), draws)
    return state.flat


def test_constant_per_step_keys_equal_the_broadcast_lattice():
    """tests/test_sweep_engine.py::TestPerStepKeys on the port: the step-key
    replay with every step given the run's own key is the plain per-run
    replay, bit for bit."""
    _, cfgs = _small_lattice()
    problem = linreg.make_problem(n=8, seed=0, c_base=1.3)
    idx = np.random.default_rng(0).integers(0, 10, (6, 2, 8, 1))
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.key(5), 2)
        table = jnp.broadcast_to(keys[None], (6,) + keys.shape)
        plain = _port_lattice(cfgs, problem, ReplaySweepDraws(keys), idx)
        stepped = _port_lattice(cfgs, problem,
                                ReplayStepKeyDraws(table, 8, 2), idx)
    assert torch.equal(plain, stepped)


def test_per_step_key_replay_matches_the_reference_round():
    """A (T, R) table of distinct keys through the reference's
    ``per_step_keys`` round and through the port's lattice (links failing
    in one run): the buffers within Z_TOL·max|z|."""
    ref_cfgs, cfgs = _small_lattice()
    problem = linreg.make_problem(n=8, seed=0, c_base=1.3)
    t_steps = 12
    idx = np.random.default_rng(1).integers(0, 10, (t_steps, 2, 8, 1))
    with jax.enable_x64(True):
        ref_problem = ref_linreg.make_problem(n=8, seed=0, c_base=1.3)
        table = jax.random.split(jax.random.key(9), t_steps * 2).reshape(
            t_steps, 2)
        plan = ref_sweep.make_sweep_plan(ref_cfgs)
        spec = ref_flat.make_flat_spec(jnp.zeros(problem.d, jnp.float64))
        round_fn = ref_sweep.make_sweep_feddec_round(
            plan, spec, ref_linreg.make_grad_fn(10),
            ref_common.paper_lr_fn(ref_problem, 4), donate=False,
            per_step_keys=True)
        gather = ref_common.sweep_minibatch_gather(ref_problem)
        state = ref_sweep.init_sweep_state(plan, spec,
                                           jnp.zeros(problem.d))
        state, _ = round_fn(state, jax.vmap(gather)(jnp.asarray(idx)),
                            table)
        want = np.asarray(state.flat)
        got = _port_lattice(cfgs, problem,
                            ReplayStepKeyDraws(table, 8, 2), idx).numpy()
    assert np.abs(got - want).max() <= Z_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# fig4 and theory_check under the reference's randomness
# ---------------------------------------------------------------------------


def _ref_fig4(t_steps: int, seeds: int):
    """The reference's fig4 lattice (benchmarks/fig4_convergence.py:62-111,
    every step's suboptimality and the final buffer kept) and a replay of
    its draws."""
    with jax.enable_x64(True):
        problem = ref_linreg.make_problem(n=20, m_rows=10, d=25, seed=0)
        graphs = {"sparse_r0.35": ref_topo.geographic_graph(20, 0.35, seed=1),
                  "dense_r0.50": ref_topo.geographic_graph(20, 0.50, seed=1)}
        cells, cfgs, gammas = ref_fig4._lattice(problem, graphs, seeds)
        plan = ref_sweep.make_sweep_plan(cfgs)
        spec = ref_flat.make_flat_spec(jnp.zeros(25, jnp.float64))
        step = ref_sweep.make_sweep_feddec_step(
            plan, spec, ref_linreg.make_grad_fn(10),
            lambda t: 2.0 / (problem.mu * (gammas + t)), jit=False)
        seed_keys = jax.random.split(jax.random.key(42), seeds)
        run_seed_keys = jnp.concatenate([seed_keys] * len(cells))
        kbs, kss = ref_common.round_key_chains(run_seed_keys, t_steps // 10)
        step_keys = ref_common.per_step_keys(kss, plan.h, t_steps)
        idx_all = ref_common.lattice_minibatch_indices(
            kbs, plan.h, t_steps, 20, 1, 10)
        gather = ref_common.sweep_minibatch_gather(problem)
        subopt = ref_common.sweep_suboptimality(problem)

        @jax.jit
        def run_all():
            state0 = ref_sweep.init_sweep_state(plan, spec, jnp.zeros(25))

            def body(state, xs):
                idx_t, keys_t = xs
                state, _ = step(state, gather(idx_t), keys_t)
                return state, subopt(state.flat)

            final, sub = jax.lax.scan(body, state0,
                                      (jnp.asarray(idx_all), step_keys))
            return sub, final.flat

        sub, flat = run_all()
        draws = ReplayStepKeyDraws(step_keys, 20, 2, minibatch=idx_all)
        return np.asarray(sub), np.asarray(flat), draws, problem.f_star


def _assert_sub_close(got, want, f_star):
    assert np.all(np.abs(got - want) <= SUB_TOL * (want + f_star))


def test_fig4_lattice_matches_the_reference_under_its_draws():
    seeds, rec = 2, 50
    ref_sub, ref_flat_, draws, f_star = _ref_fig4(T_REPLAY, seeds)
    problem, cells, plan, lr_fn, _ = fig4_convergence.make_setup(
        T_REPLAY, seeds)
    assert plan.r_runs == ref_sub.shape[1] == 8 * seeds
    state, records = common.run_lattice(problem, plan, lr_fn, draws,
                                        T_REPLAY, "cpu", record_every=1)
    got = state.flat.numpy()
    assert np.abs(got - ref_flat_).max() <= Z_TOL * np.abs(ref_flat_).max()
    sub = common.sweep_suboptimality(problem, "cpu")(records).numpy()
    _assert_sub_close(sub, ref_sub, f_star)

    # the driver itself: its CSV rows and finals are the reference's
    rows, finals, last = fig4_convergence.run_experiment(
        T_REPLAY, seeds, "cpu", draws=draws, record_every=rec)
    _assert_sub_close(last, ref_sub[-1], f_star)
    want_rows = []
    for c, (gname, h, alg) in enumerate(cells):
        curve = ref_sub[::rec, c * seeds:(c + 1) * seeds].mean(axis=1)
        want_rows += [(gname, h, alg, i * rec, v) for i, v in
                      enumerate(curve)]
        want = ref_sub[-1, c * seeds:(c + 1) * seeds].mean()
        _assert_sub_close(finals[(gname, h, alg)], want, f_star)
    assert [r[:4] for r in rows] == [r[:4] for r in want_rows]
    _assert_sub_close(np.asarray([r[4] for r in rows]),
                      np.asarray([r[4] for r in want_rows]), f_star)


def _ref_theory_check(t_steps: int):
    """The reference's theory_check (benchmarks/theory_check.py:45-117):
    its trajectory, iterates and constants, and a replay of its draws."""
    n, h, k = 20, 10, 2
    with jax.enable_x64(True):
        problem = ref_linreg.make_problem(n=n, seed=0)
        md = RefMixing(ref_topo.geographic_graph(n, 0.5, seed=1),
                       scheme="laplacian")
        lr = ref_common.paper_lr_fn(problem, h)
        grad_fn = ref_linreg.make_grad_fn(problem.m_rows)
        xs, ys = jnp.asarray(problem.x), jnp.asarray(problem.y)
        key = jax.random.key(0)
        ke_rounds, kb_list = {}, []
        for r in range(t_steps // h):
            if (r * h) % 50 == 0:
                key, ke = jax.random.split(key)
                ke_rounds[r] = ke
            key, kb = jax.random.split(key)
            kb_list.append(kb)
        step_batch_keys = jnp.concatenate(
            [jax.random.split(kb, h) for kb in kb_list])
        plan = ref_sweep.make_sweep_plan([RefFedDecConfig(mixing=md, h=h,
                                                          k=k)])
        spec = ref_flat.make_flat_spec(jnp.zeros(problem.d, xs.dtype))
        step = ref_sweep.make_sweep_feddec_step(plan, spec, grad_fn, lr,
                                                jit=False)
        run_keys = jnp.stack([jax.random.key(1)])

        @jax.jit
        def run_all():
            state0 = ref_sweep.init_sweep_state(plan, spec,
                                                jnp.zeros(problem.d))

            def body(state, bk):
                xb, yb = ref_linreg.sample_minibatch(problem, bk, m=1)
                state, _ = step(state, (xb[None], yb[None]), run_keys)
                return state, (problem.suboptimality(state.flat[0]),
                               state.flat[0])

            _, out = jax.lax.scan(body, state0, step_batch_keys)
            return out

        sub, z_rec = (np.asarray(a) for a in run_all())
        g2_max, sig2, est_idx = 0.0, [], []
        for r, ke in ke_rounds.items():
            zb = jnp.asarray(np.zeros((n, problem.d)) if r == 0
                             else z_rec[r * h - 1])
            est_idx.append(np.asarray(jax.random.randint(
                ke, (n, 1), 0, problem.m_rows)))
            batch = ref_linreg.sample_minibatch(problem, ke, m=1)
            gfull = 2 * jnp.einsum("imd,im->id", xs, jnp.einsum(
                "imd,id->im", xs, zb) - ys) / problem.m_rows
            gb = jax.vmap(lambda z, b_: grad_fn(z, b_, None)[1])(zb, batch)
            g2_max = max(g2_max, float((gb ** 2).sum(-1).max()))
            sig2.append(float(((gb - gfull) ** 2).sum(-1).mean()))
        inp = ref_theory.TheoremInputs(
            l_smooth=problem.l_smooth, mu=problem.mu, g2=2.0 * g2_max,
            sigma_bar2=2.0 * float(np.mean(sig2)),
            gamma_heterogeneity=problem.gamma_heterogeneity, n=n, k=k, h=h,
            lambda2_hat=md.lambda2_hat(),
            dist0_sq=float((problem.z_star ** 2).sum()))
        rows = jax.vmap(lambda bk: jax.random.randint(
            bk, (n, 1), 0, problem.m_rows))(step_batch_keys)
        table = jnp.broadcast_to(run_keys[None], (t_steps, 1))
        draws = ReplayStepKeyDraws(table, n, k,
                                   minibatch=np.asarray(rows)[:, None])
        return (sub, z_rec, inp, ref_theory.theorem1_curve(inp, t_steps),
                draws, np.stack(est_idx), problem.f_star)


def test_theory_check_matches_the_reference_under_its_draws():
    ref_sub, ref_z, ref_inp, ref_bound, draws, est_idx, f_star = \
        _ref_theory_check(T_REPLAY)
    problem, _, plan = theory_check.make_setup()
    _, z_rec = common.run_lattice(problem, plan,
                                  common.paper_lr_fn(problem, 10), draws,
                                  T_REPLAY, "cpu", record_every=1)
    z = z_rec[:, 0].numpy()
    assert np.abs(z - ref_z).max() <= Z_TOL * np.abs(ref_z).max()
    sub, bound, inp = theory_check.run_experiment(
        T_REPLAY, "cpu", draws=draws, est_idx=est_idx)
    _assert_sub_close(sub, ref_sub, f_star)
    for field in ("g2", "sigma_bar2"):
        got, want = getattr(inp, field), getattr(ref_inp, field)
        assert abs(got - want) <= SUB_TOL * want, field
    for field in ("l_smooth", "mu", "gamma_heterogeneity", "lambda2_hat",
                  "dist0_sq", "n", "k", "h"):
        assert getattr(inp, field) == getattr(ref_inp, field), field
    np.testing.assert_allclose(bound, ref_bound, rtol=SUB_TOL)
    assert theory_check.validate(sub, bound, inp)[1].endswith("PASS")


# ---------------------------------------------------------------------------
# The drivers on the port's own randomness, at the paper's settings
# ---------------------------------------------------------------------------


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    return tmp_path


DRIVERS = {
    "fig4_convergence": (lambda: fig4_convergence.main(device="cpu"), 8),
    "theory_check": (lambda: theory_check.main(device="cpu"), 2),
    "table1_lambda2": (lambda: table1_lambda2.main(), 3),
    "fig2_alpha": (lambda: fig2_alpha.main(device="cpu"), 2),
    "ablation_server": (lambda: ablation_server.main(device="cpu"), 1),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_passes_its_checks_on_the_cpu(name, results_dir, capsys):
    """Each driver at its full settings, seeds fixed in the code: exit 0,
    every check line PASS, one result line, its CSV under results/torch."""
    run, n_checks = DRIVERS[name]
    assert run() == 0
    out = capsys.readouterr().out.splitlines()
    checks = [ln for ln in out if "PASS" in ln or "FAIL" in ln]
    assert len(checks) == n_checks and all("PASS" in c for c in checks)
    assert sum(ln.startswith(name.split("_")[0]) and "," in ln
               for ln in out) == 1
    assert (results_dir / f"{name}.csv").exists()


@pytest.mark.parametrize("name", ["fig4_convergence", "theory_check",
                                  "fig2_alpha", "ablation_server"])
def test_driver_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"fig4_convergence": lambda: fig4_convergence.run_experiment(
               20, 1),
           "theory_check": lambda: theory_check.run_experiment(20),
           "fig2_alpha": lambda: fig2_alpha.empirical_contractions(2),
           "ablation_server": lambda: ablation_server.run_experiment(20, 1)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run[name]()


def test_figure_cli_defaults_to_the_card():
    p = common.figure_arg_parser("x", t_steps=5, seeds=2)
    args = p.parse_args([])
    assert (args.device, args.t_steps, args.seeds, args.smoke) == \
        ("cuda", 5, 2, False)
    assert p.parse_args(["--smoke", "--device", "cpu"]).device == "cpu"


def test_fig4_rejects_a_horizon_off_its_rounds():
    with pytest.raises(ValueError, match="multiple of every H"):
        fig4_convergence.make_setup(150, 1)


def test_fig4_cells_share_their_seeds_draws():
    """Common random numbers: a FedAvg run ignores the graph, so with the
    same seed and H its run on either graph is the same run, bit for bit;
    FedDec runs with that seed take the same minibatches."""
    seeds = 2
    _, _, last = fig4_convergence.run_experiment(T_REPLAY, seeds, "cpu")
    cells = [(g, h, a) for g in ("sparse_r0.35", "dense_r0.50")
             for h in (10, 100) for a in ("feddec", "fedavg")]
    runs = {c: last[i * seeds:(i + 1) * seeds] for i, c in enumerate(cells)}
    for h in (10, 100):
        assert np.array_equal(runs[("sparse_r0.35", h, "fedavg")],
                              runs[("dense_r0.50", h, "fedavg")])
        assert not np.array_equal(runs[("sparse_r0.35", h, "feddec")],
                                  runs[("dense_r0.50", h, "feddec")])
    assert runs[("sparse_r0.35", 10, "fedavg")][0] != \
        runs[("sparse_r0.35", 10, "fedavg")][1]
