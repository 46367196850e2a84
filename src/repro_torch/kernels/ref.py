"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with the reference's
arithmetic (repro/kernels/gossip_mix.py and update_mix.py): the mix
accumulates in f32 and casts to x's dtype, the optimizer step follows
repro/optim/optimizers.py's dtype rules.  The wrappers in
:mod:`repro_torch.kernels.ops` use these for CPU tensors, and the chip
check holds every kernel against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["gossip_mix", "gossip_mix_sparse", "local_step", "update_mix",
           "update_mix_sparse"]


def gossip_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X, f32 accumulation, output in x's dtype."""
    return torch.matmul(w.float(), x.float()).to(x.dtype)


def gossip_mix_sparse(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """ELL mix y_i = wd_i x_i + Σ_k wv[i, k] x[nbr[i, k]] in f32.

    Padded slots point at the row itself with weight 0 (exact +0.0).
    """
    x32 = x.float()
    acc = wd.float()[:, None] * x32
    for k in range(nbr.shape[1]):
        acc = acc + wv[:, k].float()[:, None] * x32[nbr[:, k].long()]
    return acc.to(x.dtype)


def local_step(x: torch.Tensor, g: torch.Tensor, m: torch.Tensor | None,
               eta: torch.Tensor, beta: float | None, nesterov: bool):
    """(p, new_m): sgd when ``beta`` is None, else the f32 momentum step.

    η is cast to the parameter dtype before the multiply, and the momentum
    step is cast to x's dtype after the f32 update — the reference's rules.
    """
    eta = eta.reshape(1, 1).to(x.dtype)
    if beta is None:
        return x - eta * g, None
    g32 = g.float()
    new_m = beta * m + g32
    step = beta * new_m + g32 if nesterov else new_m
    return x - eta * step.to(x.dtype), new_m


def update_mix(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    """y = W @ local_step(x, g); returns y, or (y, new_m) under momentum."""
    p, new_m = local_step(x, g, m, eta, beta, nesterov)
    y = gossip_mix(w, p)
    return y if beta is None else (y, new_m)


def update_mix_sparse(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                      nesterov=False):
    """The fused step with the ELL mix in place of W @."""
    p, new_m = local_step(x, g, m, eta, beta, nesterov)
    y = gossip_mix_sparse(nbr, wv, wd, p)
    return y if beta is None else (y, new_m)
