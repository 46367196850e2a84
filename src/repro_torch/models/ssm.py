"""Mamba2 block, prefill — State Space Duality (SSD), arXiv:2405.21060
(repro/models/ssm.py).

The sequence mixer is the scalar-identity SSM

    S_t = exp(Δ_t A_h) S_{t-1} + Δ_t B_t ⊗ x_t,      y_t = C_tᵀ S_t + D_h x_t

``ssd_chunked`` is the plain path: the paper's chunked block decomposition
(an intra-chunk masked-decay product, chunk states, a short recurrence
over them), in f32.  ``use_pallas`` runs kernel #16
(:func:`repro_torch.kernels.ops.ssd_scan`) instead.  Decode keeps (the
conv's last inputs, the f32 SSM state) per layer and takes one step of
the recurrence (``ssd_decode_step``): O(1) per token.  Under a model
group the mixer is tensor-parallel on the rank's heads (``_tp_mixer``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers
from repro_torch.models.griffin import causal_conv
from repro_torch.sharding import tp as tp_lib

__all__ = ["init_mamba2", "mamba2_block", "init_mamba2_cache", "ssd_chunked",
           "ssd_decode_step"]


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


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One-token SSD update: state (B,H,P,N) f32, x (B,H,P), dt (B,H),
    a (H,), b/c (B,N).  Returns (y (B,H,P) in x's dtype, the new state)."""
    dk = torch.exp(dt.float() * a.float())                  # (B,H)
    dx = x.float() * dt.float()[..., None]                  # (B,H,P)
    new_state = state * dk[:, :, None, None] + \
        torch.einsum("bhp,bd->bhpd", dx, b.float())
    y = torch.einsum("bhpd,bd->bhp", new_state, c.float())
    return y.to(x.dtype), new_state


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


def init_mamba2_cache(batch: int, d: int, cfg: SSMConfig,
                      dtype=torch.float32, *, device) -> dict:
    di = cfg.d_inner(d)
    nh = cfg.num_heads(d)
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * cfg.d_state),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                               device=device)}


def mamba2_block(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
                 compute_dtype, cache: dict | None = None,
                 use_pallas: bool = False, tp=None):
    """One Mamba2 mixer; x (B, S, d) → ((B, S, d), the new cache or None).
    With ``cache`` x is one token (S = 1).  With a model group ``tp`` (a
    prefill or training forward) it runs on the rank's nh/M heads
    (:func:`_tp_mixer`)."""
    if tp is not None:
        return _tp_mixer(params, x, cfg, tp, compute_dtype=compute_dtype,
                         use_pallas=use_pallas), None
    bsz, s, d = x.shape
    di = cfg.d_inner(d)
    nh = cfg.num_heads(d)
    n = cfg.d_state

    zxbcdt = layers.dense(params["in_proj"], x, compute_dtype=compute_dtype)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc, new_conv = causal_conv(xbc, params["conv_w"].to(compute_dtype),
                                params["conv_b"].to(compute_dtype),
                                None if cache is None else cache["conv"])
    xin, b, c = torch.split(F.silu(xbc), [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])    # (B,S,H) f32
    a = -torch.exp(params["a_log"])                         # (H,) < 0
    xh = xin.reshape(bsz, s, nh, cfg.head_dim)
    new_cache = None
    if cache is not None:
        y1, new_ssm = ssd_decode_step(cache["ssm"], xh[:, 0], dt[:, 0], a,
                                      b[:, 0], c[:, 0])
        y = y1[:, None]
        new_cache = {"conv": new_conv, "ssm": new_ssm}
    else:
        y = _scan(xh, dt, a, b, c, cfg, use_pallas)

    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, di)
    y = layers.rms_norm(params["norm"], y * F.silu(z))
    return layers.dense(params["out_proj"], y,
                        compute_dtype=compute_dtype), new_cache


def _scan(xh, dt, a, b, c, cfg: SSMConfig, use_pallas: bool):
    """The prefill's SSD scan from a zero state: kernel #16 or the
    chunked plain path; y (B, S, H, P)."""
    if use_pallas:
        from repro_torch.kernels import ops
        # the split views are strided: the kernel takes dense rows
        return ops.ssd_scan(xh.contiguous(), dt, a, b.contiguous(),
                            c.contiguous())
    return ssd_chunked(xh, dt, a, b, c, chunk=min(cfg.chunk_size,
                                                  xh.shape[1]))[0]


def _tp_mixer(params: dict, x: torch.Tensor, cfg: SSMConfig, tp, *,
              compute_dtype, use_pallas: bool) -> torch.Tensor:
    """The Mamba2 mixer on this rank's nh/M heads over the model group
    ``tp``, its leaves the rank's ``param_pspecs`` blocks: ``in_proj``
    (d, 2·di + 2·n + nh) and ``conv_w`` (K, di + 2·n) cut contiguously on
    their last dim, ``out_proj`` (di, d) on its rows, the rest
    replicated.

    The replicated x enters through ``copy_to`` and meets the rank's
    column block of ``in_proj``; the blocks of ``zxbcdt`` are gathered
    (``gather_from``: its gradient, partial on each rank, is summed and
    re-cut in the backward), and the rank takes z, x and dt of its heads
    and B and C whole (one group shared by every head).  The conv runs on
    those channels (``conv_w`` gathered on use, ``conv_b`` through
    ``copy_to``), the scan (#16 under ``use_pallas``) on the local heads,
    the gated norm over the whole d_inner (its sum of squares
    all-reduced, models/layers.rms_norm), and ``out_proj`` is
    row-parallel (``reduce_from``).  The gathered activation is (B, S,
    2·di + 2·n + nh), beside a weight of d·(2·di + 2·n + nh): gathering it
    moves fewer bytes than gathering the weight at the trainer's
    batches."""
    bsz, s, d = x.shape
    di, nh, n = cfg.d_inner(d), cfg.num_heads(d), cfg.d_state
    width = 2 * di + 2 * n + nh
    w_in, w_out = params["in_proj"]["w"], params["out_proj"]["w"]
    if nh % tp.size or w_in.shape != (d, width // tp.size) \
            or w_out.shape != (di // tp.size, d):
        raise NotImplementedError(
            f"tensor-parallel Mamba2 takes its {nh} heads over {tp.size} "
            f"model ranks from in_proj's column block and out_proj's row "
            f"block; got in_proj {tuple(w_in.shape)}, out_proj "
            f"{tuple(w_out.shape)} of ({d}, {width}) and ({di}, {d})")
    # gathered along its last dim, the whole comes back dim-major: made
    # row-major once, so that dt and the conv's channels reach the kernel
    # as dense rows
    zxbcdt = tp_lib.gather_from(layers.dense(
        params["in_proj"], tp_lib.copy_to(x, tp),
        compute_dtype=compute_dtype), tp, -1).contiguous()
    z, xin, b, c, dt_raw = tp_lib.local_parts(zxbcdt, (di, di, n, n, nh),
                                              tp, -1, whole=(2, 3))
    conv_dim = (cfg.d_conv, di + 2 * n)
    conv_w = torch.cat(tp_lib.local_parts(
        tp_lib.weight_for(params["conv_w"], conv_dim, tp), (di, n, n), tp,
        -1, whole=(1, 2)), dim=-1)
    conv_b = torch.cat(tp_lib.local_parts(
        tp_lib.weight_for(params["conv_b"], conv_dim[1:], tp), (di, n, n),
        tp, -1, whole=(1, 2)), dim=-1)
    xbc, _ = causal_conv(torch.cat([xin, b, c], dim=-1),
                         conv_w.to(compute_dtype), conv_b.to(compute_dtype))
    dl = di // tp.size
    xin, b, c = torch.split(F.silu(xbc), [dl, n, n], dim=-1)

    def heads(name):
        return tp_lib.weight_for(params[name], (nh,), tp, 0)

    dt = F.softplus(dt_raw.float() + heads("dt_bias"))      # (B,S,H/M) f32
    a = -torch.exp(heads("a_log"))
    xh = xin.reshape(bsz, s, nh // tp.size, cfg.head_dim)
    y = _scan(xh, dt, a, b, c, cfg, use_pallas)
    y = y + heads("d_skip").to(y.dtype)[None, None, :, None] * xh
    y = layers.rms_norm(params["norm"], y.reshape(bsz, s, dl) * F.silu(z),
                        tp=tp, width=di)
    return layers.dense(params["out_proj"], y, compute_dtype=compute_dtype,
                        tp=tp, parallel="row")
