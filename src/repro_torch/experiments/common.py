"""Shared pieces of the figure drivers (benchmarks/common.py:22-177):
the CLI, CSV and result lines, the paper's stepsize, and the linreg
lattice's minibatch gather, suboptimality and step loop.

The reference's key chains (``round_key_chains``, ``per_step_keys``,
``lattice_minibatch_indices``) are a :class:`repro_torch.core.draws.
RoundDraws` in the port: its per-round streams give the engine's draws
and, through ``minibatch_indices``, the lattice's minibatch rows.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from repro_torch.core import flat as flat_lib, sweep, theory
from repro_torch.data.linreg import LinRegProblem, make_grad_fn

__all__ = ["RESULTS_DIR", "write_csv", "emit", "figure_arg_parser",
           "paper_gamma", "paper_lr_fn", "sweep_minibatch_gather",
           "sweep_suboptimality", "run_lattice"]

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch"


def write_csv(name: str, header: list[str], rows: list[tuple]) -> str:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / name
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return str(path)


def emit(name: str, us_per_call: float, derived: str) -> None:
    """The ``name,us_per_call,derived`` result line."""
    print(f"{name},{us_per_call:.1f},{derived}")


def figure_arg_parser(description: str, *, t_steps: int | None = None,
                      seeds: int | None = None) -> argparse.ArgumentParser:
    """--seeds/--t-steps/--smoke/--device for the figure drivers;
    ``--smoke`` maps to each driver's reduced settings."""
    p = argparse.ArgumentParser(description=description)
    if t_steps is not None:
        p.add_argument("--t-steps", type=int, default=t_steps,
                       help=f"iterations T (default {t_steps})")
    if seeds is not None:
        p.add_argument("--seeds", type=int, default=seeds,
                       help=f"independent runs per cell (default {seeds})")
    p.add_argument("--smoke", action="store_true",
                   help="reduced T/seeds for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback to the CPU")
    return p


def paper_gamma(problem: LinRegProblem, h: int) -> float:
    return theory.gamma(problem.l_smooth, problem.mu, h)


def paper_lr_fn(problem: LinRegProblem, h: int):
    """The Theorem-1 stepsize for a linreg cell: η_t = 2/(μ(γ(H)+t)), in
    f64 for the (R,) step counters the lattice passes."""
    return theory.paper_stepsize(problem.mu, paper_gamma(problem, h))


def sweep_minibatch_gather(problem: LinRegProblem, device):
    """(R, n, m) row indices → the lattice's per-agent minibatch
    ``{"x": (R, n, m, d), "y": (R, n, m)}`` (f64, on ``device``)."""
    xs = torch.as_tensor(problem.x, device=device)
    ys = torch.as_tensor(problem.y, device=device)
    agents = torch.arange(problem.n, device=device)[None, :, None]

    def gather(idx: torch.Tensor) -> dict:
        return {"x": xs[agents, idx], "y": ys[agents, idx]}

    return gather


def sweep_suboptimality(problem: LinRegProblem, device):
    """(..., n, d) lattice buffers → f(z̄) − f* per leading index (the
    Fig. 4 curve), z̄ the mean over the agents."""
    xs = torch.as_tensor(problem.x, device=device)
    ys = torch.as_tensor(problem.y, device=device)

    def subopt(flat: torch.Tensor) -> torch.Tensor:
        zbar = flat.mean(dim=-2)                            # (..., d)
        res = torch.einsum("imd,...d->...im", xs, zbar) - ys
        return torch.sum(res * res, dim=-1).mean(dim=-1) / problem.m_rows \
            - problem.f_star

    return subopt


def run_lattice(problem: LinRegProblem, plan: sweep.SweepPlan, lr_fn,
                draws, t_steps: int, device, record_every: int = 0):
    """T steps of the f64 linreg lattice from z¹ = 0, one lattice step per
    iteration, each agent's one row a step (§4's m = 1) from
    ``draws.minibatch_indices``.

    Returns the final SweepFedState and the (S, R, n, d) buffers after the
    steps s (0-based) with s % record_every == 0 (none when 0): the
    reference's per-step records taken ``[::record_every]``.
    """
    spec = flat_lib.make_flat_spec(
        {"z": torch.zeros(problem.d, dtype=torch.float64)})
    step = sweep.make_sweep_feddec_step(
        plan, spec, make_grad_fn(problem.m_rows), lr_fn, device=device)
    state = sweep.init_sweep_state(plan, spec, {"z": torch.zeros(
        problem.d, dtype=torch.float64, device=device)})
    idx = draws.minibatch_indices(1, problem.m_rows)
    gather = sweep_minibatch_gather(problem, device)
    n_rec = -(-t_steps // record_every) if record_every else 0
    records = torch.empty((n_rec,) + tuple(state.flat.shape),
                          dtype=state.flat.dtype, device=device)
    for s in range(t_steps):
        state, _ = step(state, gather(idx[s]), draws)
        if record_every and s % record_every == 0:
            records[s // record_every].copy_(state.flat)
    return state, records
