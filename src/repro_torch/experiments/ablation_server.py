"""Beyond-paper ablation: does the server still help as connectivity
grows? (benchmarks/ablation_server.py)

The paper's §5 conjecture: "there exists a connectivity threshold where
the server does not help convergence anymore … for sufficiently dense
networks, server communication rounds might even hurt."

Design: the paper's linreg instance, H=10, K=2, T=3000, 6 seeds.  For each
topology (chain → ring2 → geo r=.35 → geo r=.5 → geo r=.65 → full) run
FedDec WITH the server (Alg. 1) and WITHOUT it (server_enabled=False, pure
gossip SGD), and compare the final suboptimality of z̄.  The reference runs
each cell on its tree engine; the port runs two float64 lattices of 36
runs (6 topologies × 6 seeds), one with the server and one without, since
``server_enabled`` is shared within a lattice.  Both lattices take the
same per-round draws, so every topology and both arms see the same
minibatches for a seed.

Expected per the theory: the server's benefit comes from periodically
zeroing the consensus error (Lemma 3's bound ∝ α); as α → 0 the gossip
already keeps the agents tight and the server's K=2 sampled average (which
injects variance, Lemma 4's 4αHG²/K term) loses its edge.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import sweep, topology as topo
from repro_torch.core.draws import RoundDraws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.experiments import common
from repro_torch.launch.train import resolve_device

N, T, H, K, SEEDS = 20, 3000, 10, 2, 6
SEED = 3             # the draws' seed (the reference's jax.random.key(3))


def _topologies():
    return [
        ("chain", topo.chain_graph(N)),
        ("ring2", topo.ring_graph(N, k=2)),
        ("geo_r0.35", topo.geographic_graph(N, 0.35, seed=1)),
        ("geo_r0.50", topo.geographic_graph(N, 0.50, seed=1)),
        ("geo_r0.65", topo.geographic_graph(N, 0.65, seed=1)),
        ("full", topo.fully_connected_graph(N)),
    ]


def _finals(problem, mds, server: bool, seeds: int, t_steps: int,
            device) -> np.ndarray:
    """(topologies,) seed-mean final suboptimality of one lattice."""
    plan = sweep.make_sweep_plan([
        FedDecConfig(mixing=md, h=H, k=K, server_enabled=server)
        for md in mds for _ in range(seeds)])
    draws = RoundDraws(SEED, np.tile(np.arange(seeds), len(mds)), plan.h,
                       t_steps, n=N, k=K, device=device)
    state, _ = common.run_lattice(problem, plan,
                                  common.paper_lr_fn(problem, H), draws,
                                  t_steps, device)
    last = common.sweep_suboptimality(problem, device)(state.flat)
    return last.view(len(mds), seeds).mean(dim=1).cpu().numpy()


def run_experiment(t_steps: int = T, seeds: int = SEEDS, device="cuda"):
    """Rows (graph, |λ̂₂|, α, subopt with server, without, ratio); both
    lattices take the same RoundDraws streams from SEED."""
    device = resolve_device(device)
    problem = linreg.make_problem(n=N, seed=0)
    names, graphs = zip(*_topologies())
    mds = [MixingDistribution(g, scheme="laplacian") for g in graphs]
    with_srv = _finals(problem, mds, True, seeds, t_steps, device)
    no_srv = _finals(problem, mds, False, seeds, t_steps, device)
    rows = []
    for i, (name, md) in enumerate(zip(names, mds)):
        lam = topo.lambda2_hat_fixed(md.fixed_w)
        alpha = topo.alpha_from_lambda2_hat(lam)
        rows.append((name, round(lam, 4), round(alpha, 3),
                     float(with_srv[i]), float(no_srv[i]),
                     round(float(with_srv[i] / no_srv[i]), 3)))
    return rows


def validate(rows: list) -> list[str]:
    # the sparse-vs-dense trend: with K=2 the sampled broadcast hurts
    # gossip-SGD most on sparse graphs, and the harm fades (ratio → 1)
    # as gossip alone achieves consensus
    ratios = [r[-1] for r in rows]
    harm_shrinks = ratios[0] >= ratios[-1] - 1e-3
    server_never_helps = all(r >= 0.999 for r in ratios)
    return [f"S1 server harm shrinks with connectivity "
            f"(ratio {ratios[0]:.2f} → {ratios[-1]:.2f}): "
            f"{'PASS' if harm_shrinks else 'FAIL'}",
            f"S2 §5 conjecture (dense ⇒ server useless-or-worse): "
            f"{'CONFIRMED' if ratios[-1] >= 0.95 else 'not yet'}; with "
            f"K=2 the server never helps FedDec here (all ratios ≥ 1: "
            f"{server_never_helps})"]


def main(t_steps: int = T, seeds: int = SEEDS, device="cuda") -> int:
    t0 = time.perf_counter()
    rows = run_experiment(t_steps, seeds, device)
    common.write_csv("ablation_server.csv",
                     ["graph", "lambda2_hat", "alpha", "with_server",
                      "no_server", "ratio_with_over_without"], rows)
    print("# graph, |λ̂₂|, α, subopt(with server), subopt(no server), ratio:")
    for r in rows:
        print(f"#   {r[0]:10s} {r[1]:7.4f} {r[2]:7.3f} {r[3]:10.3e} "
              f"{r[4]:10.3e} {r[5]:6.3f}")
    checks = validate(rows)
    for c in checks:
        print("#", c)
    ratios = [r[-1] for r in rows]
    common.emit("ablation_server", (time.perf_counter() - t0) * 1e6,
                f"ratio_chain={ratios[0]:.2f};ratio_full={ratios[-1]:.2f};"
                f"conjecture="
                f"{'confirmed' if ratios[-1] >= 0.95 else 'open'}")
    return 0 if "PASS" in checks[0] else 1


if __name__ == "__main__":
    p = common.figure_arg_parser(__doc__, t_steps=T, seeds=SEEDS)
    args = p.parse_args()
    if args.smoke:
        args.t_steps, args.seeds = 1000, 2
    raise SystemExit(main(args.t_steps, args.seeds, args.device))
