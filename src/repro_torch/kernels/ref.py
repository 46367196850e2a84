"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with the reference's
arithmetic (repro/kernels/gossip_mix.py and update_mix.py): the mix
accumulates in f32 and casts to x's dtype, the optimizer step follows
repro/optim/optimizers.py's dtype rules.  Every function takes one run's
(n, D) buffer or a sweep lattice's (R, n, D) buffer with per-run W (or
ELL tables) and per-run η of shape (R,); the ``*_batched`` names (the
plain versions of kernels #5–#8) are the same functions.  The wrappers in
:mod:`repro_torch.kernels.ops` use these for CPU tensors, and the chip
check holds every kernel against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["gossip_mix", "gossip_mix_sparse", "local_step", "update_mix",
           "update_mix_sparse", "gossip_mix_batched",
           "gossip_mix_sparse_batched", "update_mix_batched",
           "update_mix_sparse_batched"]


def gossip_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X (per run), f32 accumulation, output in x's dtype."""
    return torch.matmul(w.float(), x.float()).to(x.dtype)


def gossip_mix_sparse(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """ELL mix y_i = wd_i x_i + Σ_k wv[i, k] x[nbr[i, k]] in f32 (per run).

    Padded slots point at the row itself with weight 0 (exact +0.0).  Each
    term is gathered into a temporary that is scaled and accumulated in
    place and dropped before the next, so a call holds two buffers beside
    its input.
    """
    if x.ndim == 2:
        return gossip_mix_sparse(nbr[None], wv[None], wd[None], x[None])[0]
    x32 = x.float()
    runs = torch.arange(x.shape[0], device=x.device)[:, None]
    acc = wd.float()[..., None] * x32
    for k in range(nbr.shape[-1]):
        acc.add_(x32[runs, nbr[..., k].long()].mul_(
            wv[..., k].float()[..., None]))
    return acc.to(x.dtype)


def local_step(x: torch.Tensor, g: torch.Tensor, m: torch.Tensor | None,
               eta: torch.Tensor, beta: float | None, nesterov: bool):
    """(p, new_m): sgd when ``beta`` is None, else the f32 momentum step.

    η is cast to the parameter dtype before the multiply, and the momentum
    step is cast to x's dtype after the f32 update — the reference's rules.
    η holds one value per run, broadcast as (R, 1, 1) over a lattice.
    """
    eta = eta.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
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


# Kernels #5–#8: the same functions over the (R, n, D) lattice buffer.
gossip_mix_batched = gossip_mix
gossip_mix_sparse_batched = gossip_mix_sparse
update_mix_batched = update_mix
update_mix_sparse_batched = update_mix_sparse
