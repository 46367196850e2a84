"""Local optimizers as (init, update) pairs over flat buffers.

Counterparts of repro/optim/optimizers.py's sgd and momentum_sgd, with
the reference's dtype rules: the step size is cast to the parameter
dtype before the multiply, the momentum slot is f32, and the momentum
step is cast back to the parameter dtype.  ``kind``/``hyper`` tell the
engine which fused update+mix kernel reproduces the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Optimizer", "sgd", "momentum_sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair; update(params, grads, state, lr) returns
    (new_params, new_state)."""

    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple[torch.Tensor, Any]]
    kind: str = "custom"
    hyper: tuple[tuple[str, Any], ...] = ()

    def hyperparams(self) -> dict[str, Any]:
        return dict(self.hyper)


def sgd() -> Optimizer:
    """z ← z − η g  (the paper's local update, Alg. 1 line 5)."""
    def init(params):
        del params
        return ()

    def update(params, grads, state, lr):
        return params - lr.to(params.dtype) * grads.to(params.dtype), state

    return Optimizer(init, update, kind="sgd")


def momentum_sgd(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball (or nesterov) momentum with an f32 slot."""
    def init(params):
        return torch.zeros_like(params, dtype=torch.float32)

    def update(params, grads, state, lr):
        g32 = grads.float()
        new_m = beta * state + g32
        step = beta * new_m + g32 if nesterov else new_m
        return params - lr.to(params.dtype) * step.to(params.dtype), new_m

    return Optimizer(init, update, kind="momentum",
                     hyper=(("beta", beta), ("nesterov", nesterov)))
