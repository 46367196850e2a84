"""Mamba2 block, prefill — State Space Duality (SSD), arXiv:2405.21060
(repro/models/ssm.py).

The sequence mixer is the scalar-identity SSM

    S_t = exp(Δ_t A_h) S_{t-1} + Δ_t B_t ⊗ x_t,      y_t = C_tᵀ S_t + D_h x_t

``ssd_chunked`` is the plain path: the paper's chunked block decomposition
(an intra-chunk masked-decay product, chunk states, a short recurrence
over them), in f32.  ``use_pallas`` runs kernel #16
(:func:`repro_torch.kernels.ops.ssd_scan`) instead.  Decode caches
(``ssd_decode_step``, ``init_mamba2_cache``) are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers
from repro_torch.models.griffin import causal_conv

__all__ = ["init_mamba2", "mamba2_block", "ssd_chunked"]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int):
    """Chunked SSD scan from a zero state.

    x (B, S, H, P), dt (B, S, H) > 0, a (H,) < 0, b/c (B, S, N) (one group
    shared across heads), chunk L dividing S.  Returns (y (B, S, H, P) in
    x's dtype, the final state (B, H, P, N) f32)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    nc = s // chunk
    xl = (x.float() * dt.float()[..., None]).reshape(bs, nc, chunk, h, p)
    la = (dt.float() * a.float()).reshape(bs, nc, chunk, h)
    bc = b.float().reshape(bs, nc, chunk, n)
    cc = c.float().reshape(bs, nc, chunk, n)

    cum = torch.cumsum(la, dim=2)                           # (B,NC,L,H)
    total = cum[:, :, -1, :]                                # (B,NC,H)

    # intra-chunk: decay[i, j] = exp(cum_i − cum_j) for i ≥ j.  Masked
    # before the exp: above the diagonal cum_i − cum_j = Σ Δ·|A| > 0
    # overflows to inf at long chunks and large |A| (Mamba2-2.7B's 80
    # heads, 128-token chunks), and a mask applied after the exp sends
    # 0·inf = NaN into the backward of Δ and A (the reference's form,
    # repro/models/ssm.py:77-79, does; its forward equals this one's)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,NC,L,L,H)
    upper = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)
    decay = torch.exp(diff.masked_fill(upper[None, None, :, :, None],
                                       float("-inf")))
    del diff
    cb = torch.einsum("bnid,bnjd->bnij", cc, bc)            # (B,NC,L,L)
    y = torch.einsum("bnijh,bnjhp->bnihp", cb[..., None] * decay, xl)
    del decay

    # chunk states: Σ_j exp(total − cum_j) B_j ⊗ Δx_j      (B,NC,H,P,N)
    rem = torch.exp(total[:, :, None, :] - cum)             # (B,NC,L,H)
    states = torch.einsum("bnjh,bnjd,bnjhp->bnhpd", rem, bc, xl)

    # the recurrence over chunk states; each chunk reads the state before it
    decay_chunk = torch.exp(total)                          # (B,NC,H)
    state = torch.zeros(bs, h, p, n, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * decay_chunk[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,P,N)

    # y_i += C_i · (exp(cum_i) · S_prev)
    y = y + torch.einsum("bnid,bnih,bnhpd->bnihp", cc, torch.exp(cum),
                         prev_states)
    return y.reshape(bs, s, h, p).to(x.dtype), state


def init_mamba2(draws, d: int, cfg: SSMConfig, dtype) -> dict:
    di = cfg.d_inner(d)
    nh = cfg.num_heads(d)
    n = cfg.d_state
    conv_dim = di + 2 * n
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * draws.uniform((nh,)))
    return {
        # order: [z (di), x (di), B (n), C (n), dt (nh)]
        "in_proj": layers.init_dense(draws, (d, 2 * di + 2 * n + nh), dtype),
        "conv_w": (draws.normal((cfg.d_conv, conv_dim)) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=draws.device),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=draws.device)),
        "d_skip": torch.ones((nh,), device=draws.device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": layers.init_rms_norm(di, dtype, draws.device),
        "out_proj": layers.init_dense(draws, (di, d), dtype),
    }


def mamba2_block(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
                 compute_dtype, use_pallas: bool = False) -> torch.Tensor:
    """One Mamba2 mixer's prefill; x (B, S, d) → (B, S, d)."""
    bsz, s, d = x.shape
    di = cfg.d_inner(d)
    nh = cfg.num_heads(d)
    n = cfg.d_state

    zxbcdt = layers.dense(params["in_proj"], x, compute_dtype=compute_dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc = F.silu(causal_conv(xbc, params["conv_w"].to(compute_dtype),
                             params["conv_b"].to(compute_dtype)))
    xin, b, c = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])    # (B,S,H) f32
    a = -torch.exp(params["a_log"])                         # (H,) < 0
    xh = xin.reshape(bsz, s, nh, cfg.head_dim)
    if use_pallas:
        from repro_torch.kernels import ops
        # the split views are strided: the kernel takes dense rows
        y = ops.ssd_scan(xh.contiguous(), dt, a, b.contiguous(),
                         c.contiguous())
    else:
        y, _ = ssd_chunked(xh, dt, a, b, c, chunk=min(cfg.chunk_size, s))

    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, di)
    y = layers.rms_norm(params["norm"], y * F.silu(z))
    return layers.dense(params["out_proj"], y, compute_dtype=compute_dtype)
