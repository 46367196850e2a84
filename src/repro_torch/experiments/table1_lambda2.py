"""Paper Table 1: |λ₂|² for geographic and Erdős–Rényi graph families
(benchmarks/table1_lambda2.py; numpy on the host).

Laplacian (best-constant) weights [26], 10 independent graph draws per
cell, n ∈ {10, 20, 40}; geographic r ∈ {0.35, 0.5, 0.65}, ER
p ∈ {0.3, 0.5, 0.7}.  Validates the paper's reference values to ±0.15
(graph draws are random; the paper reports its own 10-draw averages) and
the two structural claims: |λ₂|² < 0.9 everywhere (⇒ α < 9), and
connectivity ↑ ⇒ |λ₂|² ↓ within every family/size.  The same graph seeds
give the reference's table exactly.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import topology as topo
from repro_torch.experiments import common
from repro_torch.launch.train import resolve_device

PAPER = {  # Table 1 of the paper
    ("geo", 0.35): {10: 0.78, 20: 0.87, 40: 0.83},
    ("geo", 0.50): {10: 0.70, 20: 0.64, 40: 0.56},
    ("geo", 0.65): {10: 0.41, 20: 0.33, 40: 0.34},
    ("er", 0.3): {10: 0.70, 20: 0.62, 40: 0.40},
    ("er", 0.5): {10: 0.42, 20: 0.29, 40: 0.17},
    ("er", 0.7): {10: 0.25, 20: 0.13, 40: 0.083},
}
SEEDS = 10


def _cell(kind: str, param: float, n: int, seeds: int) -> float:
    """One cell: the mean |λ₂|² of ``seeds`` graph draws, in one batched
    eigendecomposition."""
    graphs = [topo.geographic_graph(n, param, seed=s) if kind == "geo"
              else topo.erdos_renyi_graph(n, param, seed=s)
              for s in range(seeds)]
    ws = np.stack([topo.laplacian_weights(g) for g in graphs])
    return float(np.mean(topo.lambda2_hat_fixed_batched(ws)))


def run_experiment(seeds: int = SEEDS):
    rows, table = [], {}
    for (kind, param), ref_by_n in PAPER.items():
        for n, ref in ref_by_n.items():
            val = _cell(kind, param, n, seeds)
            table[(kind, param, n)] = val
            rows.append((kind, param, n, round(val, 4), ref,
                         round(abs(val - ref), 4)))
    return rows, table


def validate(table: dict) -> list[str]:
    checks = []
    worst = max((abs(v - PAPER[(k, p)][n]), (k, p, n))
                for (k, p, n), v in table.items())
    checks.append(f"T1 max |ours − paper| = {worst[0]:.3f} at {worst[1]}: "
                  f"{'PASS' if worst[0] < 0.15 else 'FAIL'} (tol 0.15)")
    allow = all(v < 0.9 for v in table.values())
    checks.append(f"T2 all |λ₂|² < 0.9 (⇒ α < 9): "
                  f"{'PASS' if allow else 'FAIL'}")
    mono = True
    for kind, params in (("geo", (0.35, 0.5, 0.65)), ("er", (0.3, 0.5, 0.7))):
        for n in (10, 20, 40):
            seq = [table[(kind, p, n)] for p in params]
            mono &= seq[0] > seq[1] > seq[2]
    checks.append(f"T3 connectivity↑ ⇒ |λ₂|²↓ in every family/size: "
                  f"{'PASS' if mono else 'FAIL'}")
    return checks


def main(seeds: int = SEEDS) -> int:
    t0 = time.perf_counter()
    rows, table = run_experiment(seeds)
    common.write_csv("table1_lambda2.csv",
                     ["family", "param", "n", "lambda2_sq", "paper",
                      "abs_diff"], rows)
    checks = validate(table)
    for c in checks:
        print("#", c)
    n_pass = sum("PASS" in c for c in checks)
    common.emit("table1_lambda2", (time.perf_counter() - t0) * 1e6,
                f"claims_pass={n_pass}/{len(checks)}")
    return 0 if n_pass == len(checks) else 1


if __name__ == "__main__":
    p = common.figure_arg_parser(__doc__, seeds=SEEDS)
    args = p.parse_args()
    resolve_device(args.device)  # as every driver; the table is host numpy
    raise SystemExit(main(seeds=3 if args.smoke else args.seeds))
