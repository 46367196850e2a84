"""Paper Fig. 2: α = |λ̂₂|/(1−|λ̂₂|) as a function of |λ̂₂|
(benchmarks/fig2_alpha.py).

Also validates Lemma 3's consensus-contraction prediction: for a fixed W,
repeated gossip shrinks the consensus error by ≈|λ₂|² per round, and the
random-failure case matches the Monte-Carlo |λ̂₂| = λ₂(E[WWᵀ]).  Both
contraction experiments (fixed W and p_fail = 0.5) run as one R = 2
lattice through the sweep engine's per-run W sampler
(core/sweep.py:make_sweep_w_sampler), both runs taking each round's
link uniforms from one stream.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import sweep, theory, topology as topo
from repro_torch.core.draws import Draws, RoundDraws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.experiments import common
from repro_torch.launch.train import resolve_device

P_FAILS = (0.0, 0.5)
N, D, ROUNDS = 20, 64, 30
SEED = 7             # the W draws' stream (the reference's key(7))
LAMBDA_SEED = 1      # the Monte-Carlo |λ̂₂|'s draws (the reference's key(1))


def run_curve():
    xs = np.linspace(0.0, 0.98, 50)
    return [(float(x), theory.alpha(float(x))) for x in xs]


def empirical_contractions(rounds: int = ROUNDS, seed: int = 0,
                           device="cuda"):
    """{p_fail: (|λ̂₂|, mean contraction ratio over the first 10 rounds)}.

    x⁰ is an (n, 64) f32 normal draw from ``seed``, the same in both runs;
    round i mixes x with W^i sampled from a RoundDraws on SEED, one
    stream for both runs.
    """
    device = resolve_device(device)
    g = topo.geographic_graph(N, 0.5, seed=3)
    mds = [MixingDistribution(g, p_fail=p,
                              scheme="metropolis" if p else "laplacian")
           for p in P_FAILS]
    lam_hats = [md.lambda2_hat(Draws(LAMBDA_SEED, "cpu"), 4096)
                for md in mds]
    plan = sweep.make_sweep_plan([FedDecConfig(mixing=md) for md in mds])
    sampler = sweep.make_sweep_w_sampler(plan, device)
    draws = RoundDraws(SEED, np.zeros(len(mds)), np.ones(len(mds)), rounds,
                       n=N, k=1, device=device, link_failures=True)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32,
                        device=device).expand(len(mds), N, D)

    def err(x):
        return ((x - x.mean(dim=1, keepdim=True)) ** 2).sum(dim=(1, 2))

    e0 = err(x)
    errors = torch.empty((rounds, len(mds)), device=device)
    for i in range(rounds):
        w = sampler(draws, np.full(len(mds), i + 1))
        x = torch.bmm(w.to(x.dtype), x)
        errors[i] = err(x)
    e0, errors = e0.cpu().numpy(), errors.cpu().numpy()
    out = {}
    for r, p in enumerate(P_FAILS):
        e_prev, ratios = e0[r], []
        for e in errors[:, r]:
            if e_prev > 1e-25:
                ratios.append(e / e_prev)
            e_prev = e
        out[p] = (lam_hats[r], float(np.mean(ratios[:10])))
    return out


def validate(con: dict) -> list[str]:
    lam_fixed, ratio_fixed = con[0.0]
    lam_fail, ratio_fail = con[0.5]
    ok_fixed = ratio_fixed <= lam_fixed * 1.15
    ok_fail = ratio_fail <= lam_fail * 1.25
    return [f"F1 fixed W: contraction/round {ratio_fixed:.3f} ≤ |λ̂₂| "
            f"{lam_fixed:.3f} (Lemma 3): {'PASS' if ok_fixed else 'FAIL'}",
            f"F2 p_fail=0.5: contraction {ratio_fail:.3f} ≲ |λ̂₂| "
            f"{lam_fail:.3f}: {'PASS' if ok_fail else 'FAIL'}"]


def main(device="cuda") -> int:
    t0 = time.perf_counter()
    common.write_csv("fig2_alpha.csv", ["lambda2_hat", "alpha"], run_curve())
    checks = validate(empirical_contractions(device=device))
    for c in checks:
        print("#", c)
    n_pass = sum("PASS" in c for c in checks)
    common.emit("fig2_alpha", (time.perf_counter() - t0) * 1e6,
                f"claims_pass={n_pass}/2")
    return 0 if n_pass == 2 else 1


if __name__ == "__main__":
    p = common.figure_arg_parser(__doc__)
    args = p.parse_args()  # --smoke accepted for uniformity; already cheap
    raise SystemExit(main(args.device))
