"""Theorem 1 validation: the bound dominates the measured trajectory
(benchmarks/theory_check.py).

All constants are computed from the problem instance (L, μ, Γ exactly; G²
and σ̄² estimated by sampling gradients along the trajectory, then inflated
2× as a safe upper bound, since Assumption 1.3 requires a uniform bound).
The trajectory is the R = 1 lattice of the port's sweep engine in float64,
its iterate recorded at every step; the estimation then replays against
the recorded iterates every 50 steps.

Checks:

  B1  E[f(z̄^t)] − f(z*) ≤ bound(t) for all recorded t;
  B2  the FedDec B-constant is below the FedAvg C-constant (αH vs H²) for
      the measured |λ̂₂| and H.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import sweep, theory, topology as topo
from repro_torch.core.draws import RoundDraws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.experiments import common
from repro_torch.launch.train import resolve_device

N, T, H, K = 20, 3000, 10, 2
SEED = 0              # the draws' seed (the reference's jax.random.key(0))
EST_EVERY = 50        # the G²/σ̄² estimation's period, in steps


def make_setup():
    """(problem, mixing distribution, R = 1 plan) of the check."""
    problem = linreg.make_problem(n=N, seed=0)
    md = MixingDistribution(topo.geographic_graph(N, 0.5, seed=1),
                            scheme="laplacian")
    return problem, md, sweep.make_sweep_plan(
        [FedDecConfig(mixing=md, h=H, k=K)])


def estimation_indices(t_steps: int, n: int = N, m_rows: int = 10,
                       seed: int = SEED) -> np.ndarray:
    """(E, n, 1) minibatch rows of the E estimation points (every
    EST_EVERY steps from t = 1), from their own stream."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1 << 20)))
    n_est = -(-t_steps // EST_EVERY)
    return rng.integers(0, m_rows, (n_est, n, 1))


def run_experiment(t_steps: int = T, device="cuda", draws=None,
                   est_idx: np.ndarray | None = None):
    """The trajectory on ``device`` and the bound from the constants it
    gives.  ``draws`` defaults to the port's RoundDraws from SEED and
    ``est_idx`` to :func:`estimation_indices`; a test passes the
    reference's.  Returns (sub (T,), bound (T,), TheoremInputs)."""
    device = resolve_device(device)
    if t_steps % H:
        raise ValueError(f"T = {t_steps} must be a multiple of H = {H}")
    problem, md, plan = make_setup()
    if draws is None:
        draws = RoundDraws(SEED, [0], plan.h, t_steps, n=N, k=K,
                           device=device)
    if est_idx is None:
        est_idx = estimation_indices(t_steps, N, problem.m_rows)
    _, z_rec = common.run_lattice(problem, plan,
                                  common.paper_lr_fn(problem, H), draws,
                                  t_steps, device, record_every=1)
    sub = common.sweep_suboptimality(problem, device)(z_rec)[:, 0]

    # G²/σ̄² along the recorded trajectory at t = 1, 51, 101, ...: zb is
    # the iterate before that step (z¹ = 0 first)
    starts = np.arange(0, t_steps, EST_EVERY)
    zb = torch.cat([torch.zeros_like(z_rec[:1, 0]),
                    z_rec[starts[1:] - 1, 0]])                   # (E, n, d)
    xs = torch.as_tensor(problem.x, device=device)
    ys = torch.as_tensor(problem.y, device=device)
    gfull = 2 * torch.einsum("imd,eim->eid", xs, torch.einsum(
        "imd,eid->eim", xs, zb) - ys) / problem.m_rows
    batch = common.sweep_minibatch_gather(problem, device)(
        torch.as_tensor(est_idx, device=device))     # (E, n, 1, ...) rows
    rows = zb.shape[0] * N
    _, gb = torch.func.vmap(linreg.make_grad_fn(problem.m_rows))(
        {"z": zb.reshape(rows, problem.d)},
        {k: v.reshape((rows,) + v.shape[2:]) for k, v in batch.items()})
    gb = gb["z"].view(zb.shape)
    g2_max = float((gb ** 2).sum(-1).max())
    sig2 = ((gb - gfull) ** 2).sum(-1).mean(-1).cpu().numpy()

    inp = theory.TheoremInputs(
        l_smooth=problem.l_smooth, mu=problem.mu,
        g2=2.0 * g2_max, sigma_bar2=2.0 * float(np.mean(sig2)),
        gamma_heterogeneity=problem.gamma_heterogeneity, n=N, k=K, h=H,
        lambda2_hat=md.lambda2_hat(),
        dist0_sq=float((problem.z_star ** 2).sum()))
    return sub.cpu().numpy(), theory.theorem1_curve(inp, t_steps), inp


def validate(sub: np.ndarray, bound: np.ndarray,
             inp: theory.TheoremInputs) -> list[str]:
    dominated = bool((sub <= bound[:len(sub)]).all())
    a = theory.alpha(inp.lambda2_hat)
    kw = dict(k=inp.k, h=inp.h, g2=inp.g2, l_smooth=inp.l_smooth,
              gamma_heterogeneity=inp.gamma_heterogeneity,
              sigma_bar2=inp.sigma_bar2, n=inp.n)
    b_dec = theory.bound_constant_B(alpha_val=a, **kw)
    c_avg = theory.fedavg_bound_constant(**kw)
    return [f"B1 bound dominates trajectory for all t: "
            f"{'PASS' if dominated else 'FAIL'} "
            f"(max ratio {float((sub / bound[:len(sub)]).max()):.3f})",
            f"B2 B_feddec={b_dec:.3e} < C_fedavg={c_avg:.3e} "
            f"(α={a:.2f} vs H={inp.h}): "
            f"{'PASS' if b_dec < c_avg else 'FAIL'}"]


def main(t_steps: int = T, device="cuda") -> int:
    t0 = time.perf_counter()
    sub, bound, inp = run_experiment(t_steps, device)
    ts = np.arange(1, len(sub) + 1)
    rows = list(zip(ts[::25], sub[::25], bound[::25]))
    common.write_csv("theory_check.csv", ["t", "empirical", "bound"], rows)
    checks = validate(sub, bound, inp)
    for c in checks:
        print("#", c)
    n_pass = sum("PASS" in c for c in checks)
    common.emit("theory_check", (time.perf_counter() - t0) * 1e6,
                f"claims_pass={n_pass}/2")
    return 0 if n_pass == 2 else 1


if __name__ == "__main__":
    p = common.figure_arg_parser(__doc__, t_steps=T)
    args = p.parse_args()
    raise SystemExit(main(1500 if args.smoke else args.t_steps, args.device))
