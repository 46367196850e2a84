"""Local optimizers as (init, update) pairs (repro/optim/optimizers.py).

Each takes a tensor (the flat engine's (n, D) buffer, a lattice's
(R, n, D) one) or a nested dict of tensors (the tree engine's parameters),
as the reference's ``jax.tree.map`` bodies take any pytree.  The
reference's dtype rules hold: the step size is cast to the parameter
dtype before the multiply, the momentum and Adam slots are f32, adamw's
count is int32 with its bias corrections in f32, and each step is cast
back to the parameter dtype.  ``kind``/``hyper`` tell the engine which
fused update+mix kernel reproduces the update (sgd and momentum; adamw
keeps the unfused path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["Optimizer", "sgd", "momentum_sgd", "adamw",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair; update(params, grads, state, lr) returns
    (new_params, new_state)."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]
    kind: str = "custom"
    hyper: tuple[tuple[str, Any], ...] = ()

    def hyperparams(self) -> dict[str, Any]:
        return dict(self.hyper)


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def sgd() -> Optimizer:
    """z ← z − η g  (the paper's local update, Alg. 1 line 5)."""
    def init(params):
        del params
        return ()

    def update(params, grads, state, lr):
        return tree_map(lambda p, g: p - lr.to(p.dtype) * g.to(p.dtype),
                        params, grads), state

    return Optimizer(init, update, kind="sgd")


def momentum_sgd(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball (or nesterov) momentum with an f32 slot."""
    def update(params, grads, state, lr):
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        step = tree_map(lambda m, g: beta * m + g.float(), new_m, grads) \
            if nesterov else new_m
        return tree_map(lambda p, d: p - lr.to(p.dtype) * d.to(p.dtype),
                        params, step), new_m

    return Optimizer(_f32_zeros, update, kind="momentum",
                     hyper=(("beta", beta), ("nesterov", nesterov)))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay: f32 moment slots ``m``/``v`` in
    the parameters' layout and an int32 ``count``."""
    def init(params):
        return {"m": _f32_zeros(params), "v": _f32_zeros(params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves(params)[0].device)}

    def update(params, grads, state, lr):
        c = state["count"] + 1
        cf = c.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def upd(p, m_, v_):
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return p - (lr * step).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v, "count": c}

    return Optimizer(init, update, kind="adamw",
                     hyper=(("b1", b1), ("b2", b2), ("eps", eps),
                            ("weight_decay", weight_decay)))


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled by min(1, max_norm / (‖grads‖₂ + 1e-9)), the norm
    over every leaf in f32, each leaf cast back to its dtype."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
