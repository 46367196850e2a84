"""Paper Fig. 4: FedDec vs FedAvg on heterogeneous linear regression
(benchmarks/fig4_convergence.py).

The §4 setup: n=20 agents, d=25, M=10 rows/agent, c_i = 2^i
heterogeneity, minibatch m=1, K=2 partial participation, T=5000
iterations, stepsize η_t = 2/(μ(γ+t)) from Theorem 1, geographic graphs
r ∈ {0.35, 0.5} (Fig. 3), H ∈ {10, 100}, Laplacian mixing weights, 10
runs per cell.  The whole (graph × H × alg × seed) lattice, 80 runs, is
one (R, n, d) float64 buffer on the port's sweep engine, advanced one
lattice step per iteration; every run re-keys its draws at each of its
server rounds from its seed's streams (core/draws.py:RoundDraws), so
cells with the same seed and H share their minibatches and server draws
whatever their graph or algorithm.  The suboptimality f(z̄^t) − f* is
taken every ``record_every`` steps and at the end.

Validated claims:
  C1  FedDec reaches lower suboptimality than FedAvg in all four settings;
  C2  the FedDec/FedAvg gap grows with H (horizontal comparison in Fig. 4);
  C3  the gap grows with connectivity (vertical comparison: r=0.5 > r=0.35).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import sweep, theory, topology as topo
from repro_torch.core.draws import RoundDraws
from repro_torch.core.feddec import FedAvgConfig, FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.experiments import common
from repro_torch.launch.train import resolve_device

N, D, M_ROWS, T, K = 20, 25, 10, 5000, 2
SEEDS = 10
H_VALUES = (10, 100)
SEED = 42            # the draws' seed (the reference's jax.random.key(42))
RECORD_EVERY = 50


def _lattice(problem, graphs: dict, seeds: int):
    """The figure's (graph × H × alg) cells × seeds, in CSV row order:
    (cells, per-run configs, per-run γ, per-run seed ids)."""
    cells, cfgs, gammas = [], [], []
    for gname, graph in graphs.items():
        for h in H_VALUES:
            for alg in ("feddec", "fedavg"):
                cells.append((gname, h, alg))
                if alg == "feddec":
                    fcfg = FedDecConfig(
                        mixing=MixingDistribution(graph, scheme="laplacian"),
                        h=h, k=K)
                else:
                    fcfg = FedAvgConfig(N, h=h, k=K)
                cfgs.extend([fcfg] * seeds)
                gammas.extend([common.paper_gamma(problem, h)] * seeds)
    seed_ids = np.tile(np.arange(seeds), len(cells))
    return cells, cfgs, np.asarray(gammas), seed_ids


def make_setup(t_steps: int = T, seeds: int = SEEDS):
    """(problem, cells, plan, lr_fn, seed ids) of the figure's lattice."""
    if any(t_steps % h for h in H_VALUES):
        raise ValueError(f"T = {t_steps} must be a multiple of every H "
                         f"{H_VALUES}")
    problem = linreg.make_problem(n=N, m_rows=M_ROWS, d=D, seed=0)
    graphs = {"sparse_r0.35": topo.geographic_graph(N, 0.35, seed=1),
              "dense_r0.50": topo.geographic_graph(N, 0.50, seed=1)}
    cells, cfgs, gammas, seed_ids = _lattice(problem, graphs, seeds)
    plan = sweep.make_sweep_plan(cfgs)
    return problem, cells, plan, theory.paper_stepsize(problem.mu, gammas), \
        seed_ids


def run_experiment(t_steps: int = T, seeds: int = SEEDS, device="cuda",
                   draws=None, record_every: int = RECORD_EVERY):
    """The lattice on ``device``.  ``draws`` defaults to the port's own
    RoundDraws from SEED; a test passes a replay of the reference's.

    Returns (CSV rows, per-cell seed-mean finals, per-run finals (R,)).
    """
    device = resolve_device(device)
    problem, cells, plan, lr_fn, seed_ids = make_setup(t_steps, seeds)
    if draws is None:
        draws = RoundDraws(SEED, seed_ids, plan.h, t_steps, n=N, k=K,
                           device=device)
    subopt = common.sweep_suboptimality(problem, device)
    state, records = common.run_lattice(problem, plan, lr_fn, draws,
                                        t_steps, device, record_every)
    sub_rec = subopt(records).cpu().numpy()             # (T/rec, R)
    last = subopt(state.flat).cpu().numpy()             # (R,)

    rows, finals = [], {}
    for c, (gname, h, alg) in enumerate(cells):
        cols = slice(c * seeds, (c + 1) * seeds)
        mean_curve = sub_rec[:, cols].mean(axis=1)
        finals[(gname, h, alg)] = float(last[cols].mean())
        for i, v in enumerate(mean_curve):
            rows.append((gname, h, alg, i * record_every, float(v)))
    return rows, finals, last


def validate(finals: dict) -> list[str]:
    checks = []
    for g in ("sparse_r0.35", "dense_r0.50"):
        for h in (10, 100):
            dec, avg = finals[(g, h, "feddec")], finals[(g, h, "fedavg")]
            checks.append(
                f"C1 {g} H={h}: feddec {dec:.3e} < fedavg {avg:.3e}: "
                f"{'PASS' if dec < avg else 'FAIL'}")
    for g in ("sparse_r0.35", "dense_r0.50"):
        gain10 = finals[(g, 10, "fedavg")] / finals[(g, 10, "feddec")]
        gain100 = finals[(g, 100, "fedavg")] / finals[(g, 100, "feddec")]
        checks.append(f"C2 {g}: gain(H=100)={gain100:.2f} > "
                      f"gain(H=10)={gain10:.2f}: "
                      f"{'PASS' if gain100 > gain10 else 'FAIL'}")
    for h in (10, 100):
        gs = finals[("sparse_r0.35", h, "fedavg")] / \
            finals[("sparse_r0.35", h, "feddec")]
        gd = finals[("dense_r0.50", h, "fedavg")] / \
            finals[("dense_r0.50", h, "feddec")]
        checks.append(f"C3 H={h}: dense gain {gd:.2f} > sparse gain "
                      f"{gs:.2f}: {'PASS' if gd > gs else 'FAIL'}")
    return checks


def main(t_steps: int = T, seeds: int = SEEDS, device="cuda") -> int:
    t0 = time.perf_counter()
    rows, finals, _ = run_experiment(t_steps, seeds, device)
    common.write_csv("fig4_convergence.csv",
                     ["graph", "H", "alg", "t", "suboptimality"], rows)
    checks = validate(finals)
    for c in checks:
        print("#", c)
    n_pass = sum("PASS" in c for c in checks)
    common.emit("fig4_feddec_vs_fedavg", (time.perf_counter() - t0) * 1e6,
                f"claims_pass={n_pass}/{len(checks)}")
    return 0 if n_pass == len(checks) else 1


if __name__ == "__main__":
    p = common.figure_arg_parser(__doc__, t_steps=T, seeds=SEEDS)
    args = p.parse_args()
    if args.smoke:
        args.t_steps, args.seeds = 1500, 3
    raise SystemExit(main(args.t_steps, args.seeds, args.device))
