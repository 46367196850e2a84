"""Learning-rate schedules (step → η_t) (repro/optim/schedules.py).

Each schedule returns η_t as a tensor in the ``dtype`` and on the
``device`` its caller asks for, shaped like ``t`` (an int, or the (R,)
per-run step counters of a sweep lattice): a float64 lattice keeps its
η in float64 beside its buffer.  The value is computed in float64 on the
host and cast once; :func:`paper_diminishing` is then bit for bit the
reference's 2/(μ(γ+t)) under float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["constant", "paper_diminishing", "linear_warmup",
           "cosine_decay"]


def _eta(value, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float64).to(dtype=dtype,
                                                          device=device)


def _steps(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float64)


def constant(lr: float, *, dtype=torch.float32, device):
    eta = _eta(lr, dtype, device)
    return lambda t: eta


def paper_diminishing(mu: float, gamma, *, dtype=torch.float64, device):
    """η_t = 2/(μ(γ+t)): Theorem 1's schedule (t counts from 1).  ``gamma``
    may be an (R,) array of per-run γ, broadcast against t."""
    def fn(t):
        return _eta(2.0 / (mu * (gamma + _steps(t))), dtype, device)
    return fn


def linear_warmup(peak: float, warmup_steps: int, *, dtype=torch.float32,
                  device):
    def fn(t):
        frac = np.minimum(_steps(t) / max(warmup_steps, 1), 1.0)
        return _eta(peak * frac, dtype, device)
    return fn


def cosine_decay(peak: float, total_steps: int, warmup_steps: int = 0,
                 floor: float = 0.0, *, dtype=torch.float32, device):
    def fn(t):
        t = _steps(t)
        warm = np.minimum(t / max(warmup_steps, 1), 1.0) if warmup_steps \
            else 1.0
        prog = np.clip((t - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
        cos = 0.5 * (1 + np.cos(math.pi * prog))
        return _eta((floor + (peak - floor) * cos) * warm, dtype, device)
    return fn
