"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with the reference's
arithmetic (repro/kernels/gossip_mix.py, update_mix.py and
compress_mix.py): the mix accumulates in f32 and casts to x's dtype,
the optimizer step follows repro/optim/optimizers.py's dtype rules.
A float64 buffer is mixed in f32 too, as the reference's kernels mix it:
the optimizer step and the EF correction and residual run in the
buffer's dtype, the mix's sum in f32 (repro/kernels/update_mix.py:
_local_step, _dense_mix, ef_mix_kernel).
The model zoo's prefill kernels (#15–#17, flash_attention.py, ssd_scan.py
and rglru_scan.py) have theirs at the end of the module.
The ``*_batched`` names (the plain versions of kernels #5–#8, #10 and
#12) take a sweep lattice's (R, n, D) buffer with per-run W (or ELL
tables) and per-run η of shape (R,), and call the single-run function
once per run (:func:`_by_run`), so a run's slice equals the single-run
plain version on it bit for bit, as the kernels' slices do.  The wrappers in
:mod:`repro_torch.kernels.ops` use these for CPU tensors, and the chip
check holds every kernel against them on the card.
"""

from __future__ import annotations

import torch

__all__ = ["gossip_mix", "ell_mix", "gossip_mix_sparse", "local_step",
           "update_mix", "update_mix_sparse", "gossip_mix_batched",
           "gossip_mix_sparse_batched", "update_mix_batched",
           "update_mix_sparse_batched", "ef_mix", "ef_mix_sparse",
           "ef_mix_batched", "ef_mix_sparse_batched", "quantize_int8",
           "quant_mix", "dequant_mix", "flash_attention_ref", "ssd_scan_ref",
           "rglru_scan_ref"]


def gossip_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X (per run), f32 accumulation, output in x's dtype."""
    return torch.matmul(w.float(), x.float()).to(x.dtype)


def ell_mix(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
            x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """ELL mix y_i = wd_i x_i + Σ_k wv[i, k] x[nbr[i, k]] (per run),
    computed in ``dt``, output in x's dtype.

    Padded slots point at the row itself with weight 0 (exact +0.0).  Each
    term is gathered into a temporary that is scaled and accumulated in
    place and dropped before the next, so a call holds two buffers beside
    its input.
    """
    if x.ndim == 2:
        return ell_mix(nbr[None], wv[None], wd[None], x[None], dt)[0]
    xa = x.to(dt)
    runs = torch.arange(x.shape[0], device=x.device)[:, None]
    acc = wd.to(dt)[..., None] * xa
    for k in range(nbr.shape[-1]):
        acc.add_(xa[runs, nbr[..., k].long()].mul_(
            wv[..., k].to(dt)[..., None]))
    return acc.to(x.dtype)


def gossip_mix_sparse(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """The ELL mix in f32 (per run), output in x's dtype."""
    return ell_mix(nbr, wv, wd, x, torch.float32)


def local_step(x: torch.Tensor, g: torch.Tensor, m: torch.Tensor | None,
               eta: torch.Tensor, beta: float | None, nesterov: bool):
    """(p, new_m): sgd when ``beta`` is None, else the f32 momentum step.

    η is cast to the parameter dtype before the multiply, and the momentum
    step is cast to x's dtype after the f32 update — the reference's rules.
    η holds one value per run, broadcast as (R, 1, 1) over a lattice.
    A bfloat16 buffer takes :func:`_local_step_bf16`'s rounding.
    """
    eta = eta.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    if x.dtype == torch.bfloat16:
        return _local_step_bf16(x, g, m, eta, beta, nesterov)
    if beta is None:
        return x - eta * g, None
    g32 = g.float()
    new_m = beta * m + g32
    step = beta * new_m + g32 if nesterov else new_m
    return x - eta * step.to(x.dtype), new_m


def _local_step_bf16(x, g, m, eta, beta, nesterov):
    """The bf16 step as the reference's kernels compute it under XLA
    (repro/kernels/update_mix.py:_local_step feeding _dense_mix/_ell_mix):
    m' = fma(β, m, g) and the nesterov step fma(β, m', g) in f32 (XLA
    contracts β·m + g), the step rounded to bf16, the product η·step
    rounded to bf16, and x − η·step left in f32, unrounded, since the mix
    reads it as f32.  So p is an f32 tensor; the mix rounds y to bf16."""
    if beta is None:
        step, new_m = g, None
    else:
        g32 = g.float()
        new_m = _fma32(beta, m, g32)
        step = (_fma32(beta, new_m, g32) if nesterov else new_m).to(x.dtype)
    return x.float().sub_((eta * step).float()), new_m


_FMA_CHUNK = 1 << 24


def _fma32(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(f32(a), b, c) over f32 tensors, rounded once to f32.

    The product is exact in f64; the f64 sum is rounded to odd (its last
    bit set where the sum was inexact), after which rounding to f32 gives
    the correctly rounded fma (53 ≥ 2·24 + 2 bits).  Flat chunks of
    ``_FMA_CHUNK`` elements bound the f64 temporaries."""
    a64 = float(torch.tensor(a, dtype=torch.float32))
    out = torch.empty_like(b)
    bf, cf, of = b.reshape(-1), c.reshape(-1), out.view(-1)
    for lo in range(0, bf.numel(), _FMA_CHUNK):
        prod = bf[lo:lo + _FMA_CHUNK].double().mul_(a64)
        cc = cf[lo:lo + _FMA_CHUNK].double()
        s = prod + cc
        bb = s - prod                               # TwoSum's error term
        err = (prod - (s - bb)).add_(cc - bb)
        even = (s.view(torch.int64) & 1) == 0
        odd = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
        of[lo:lo + _FMA_CHUNK] = torch.where((err != 0) & even, odd, s)
    return out


def update_mix(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    """y = W @ local_step(x, g); returns y, or (y, new_m) under momentum."""
    p, new_m = local_step(x, g, m, eta, beta, nesterov)
    y = gossip_mix(w, p).to(x.dtype)
    return y if beta is None else (y, new_m)


def update_mix_sparse(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                      nesterov=False):
    """The fused step with the ELL mix in place of W @."""
    p, new_m = local_step(x, g, m, eta, beta, nesterov)
    y = gossip_mix_sparse(nbr, wv, wd, p).to(x.dtype)
    return y if beta is None else (y, new_m)


def _by_run(single, *args, **kw):
    """``single`` on each run's slices of the tensor arguments (R leading),
    written into (R, ...) outputs.  One 2-D product per run, as the
    single-run plain version computes it: a batched matmul over the runs
    sums in another order on the CPU (1 ulp apart in a few elements)."""
    runs = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]

    def pick(a, i):
        return a[i] if isinstance(a, torch.Tensor) else a

    outs = None
    for i in range(runs):
        got = single(*(pick(a, i) for a in args),
                     **{k: pick(v, i) for k, v in kw.items()})
        got = got if isinstance(got, tuple) else (got,)
        if outs is None:
            outs = tuple(torch.empty((runs,) + tuple(g.shape), dtype=g.dtype,
                                     device=g.device) for g in got)
        for out, g in zip(outs, got):
            out[i] = g
        del got
    return outs if len(outs) > 1 else outs[0]


# Kernels #5–#8: #1–#4 per run over the (R, n, D) lattice buffer.
def gossip_mix_batched(w, x):
    return _by_run(gossip_mix, w, x)


def gossip_mix_sparse_batched(nbr, wv, wd, x):
    return _by_run(gossip_mix_sparse, nbr, wv, wd, x)


def update_mix_batched(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    return _by_run(update_mix, w, x, g, eta, m, beta=beta, nesterov=nesterov)


def update_mix_sparse_batched(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                              nesterov=False):
    return _by_run(update_mix_sparse, nbr, wv, wd, x, g, eta, m, beta=beta,
                   nesterov=nesterov)


# ---------------------------------------------------------------------------
# Compressed gossip: the EF receive side (#9–#12) and the int8 mixes
# (#13/#14).  Each temporary is reused in place where the rounding allows
# it, so a call at full width holds few (n, D) buffers beside its inputs.
# ---------------------------------------------------------------------------


def _diag(w: torch.Tensor, dtype) -> torch.Tensor:
    """diag(W) as (..., n, 1) in ``dtype``, for the per-row correction."""
    return torch.diagonal(w, dim1=-2, dim2=-1).to(dtype)[..., None]


def _correct(mix: torch.Tensor, diag: torch.Tensor, p: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """mix + diag·(p − s), rounded op by op: (p − s), then ·diag, then +."""
    return mix.add_(torch.sub(p, s).mul_(diag))


def ef_mix(w, p, s, u):
    """#9 (y, r) = ((W s)→p.dtype + diag(W)·(p − s), u − s)
    (repro/kernels/update_mix.py:ef_mix_kernel): the mix accumulates in f32
    and is cast to p's dtype before the diagonal term is added."""
    y = _correct(gossip_mix(w, s).to(p.dtype), _diag(w, p.dtype), p, s)
    return y, u - s


def ef_mix_sparse(nbr, wv, wd, p, s, u):
    """#11 the ELL form of #9: wd doubles as diag(W)."""
    mix = gossip_mix_sparse(nbr, wv, wd, s).to(p.dtype)
    y = _correct(mix, wd.to(p.dtype)[..., None], p, s)
    return y, u - s


# Kernels #10/#12: #9/#11 per run over the (R, n, D) lattice buffer.
def ef_mix_batched(w, p, s, u):
    return _by_run(ef_mix, w, p, s, u)


def ef_mix_sparse_batched(nbr, wv, wd, p, s, u):
    return _by_run(ef_mix_sparse, nbr, wv, wd, p, s, u)


def quantize_int8(u, noise, scale):
    """q = clip(⌊u/scale + noise⌋, ±127) as f32 values, scale one per row
    (repro/kernels/compress_mix.py:quant_mix_kernel and
    repro/core/compress.py:Int8Compressor.encode round alike)."""
    qf = u.float() / scale.float()[..., None]
    return qf.add_(noise).floor_().clamp_(-127.0, 127.0)


def _int8_mix(w, qf, scale, p):
    """y = W (q·scale) + diag(W)·(p − q·scale), everything in f32."""
    s = qf.mul_(scale.float()[..., None])  # q·scale, in q's buffer
    mix = torch.matmul(w.float(), s)
    return _correct(mix, _diag(w, torch.float32), p.float(), s).to(p.dtype)


def quant_mix(w, u, noise, p, scale):
    """#13 the send side: (y, q) with q = clip(⌊u/scale + noise⌋, ±127)
    int8 and y mixed from s = q·scale, all in f32 and cast at the end."""
    qf = quantize_int8(u, noise, scale)
    q = qf.to(torch.int8)
    return _int8_mix(w, qf, scale, p), q


def dequant_mix(w, q, scale, p):
    """#14 the receive side: y mixed straight from the int8 payload,
    s = q·scale, all in f32 and cast at the end."""
    return _int8_mix(w, q.float(), scale, p)


# ---------------------------------------------------------------------------
# The model zoo's prefill kernels: #15 flash attention, #16 the SSD scan,
# #17 the RG-LRU scan.  f32 arithmetic throughout, outputs cast at the end.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, window: int = 0, scale=None):
    """#15 causal GQA attention, limited to the last ``window`` keys when
    ``window`` > 0: q (B, S, H, hd), k/v (B, S, KV, hd), head h reads KV
    head h // (H / KV).  q is scaled in f32 before QKᵀ, the softmax is
    taken in f32 and the probabilities stay f32 for the PV product, as in
    the Pallas body (repro/kernels/flash_attention.py:_flash_kernel);
    output in q's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qg = q.reshape(b, s, kv, h // kv, hd).float() * scale
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    probs = torch.softmax(scores.masked_fill_(~mask, NEG_INF), dim=-1)
    del scores
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def ssd_scan_ref(x, dt, a, b, c):
    """#16 the Mamba2 SSD scan from a zero state, token by token:
    S_t = exp(Δ_t A_h) S_{t−1} + (Δ_t x_t) ⊗ B_t, y_t = S_t C_t, the
    (H, P, N) state in f32.  x (B, S, H, P), dt (B, S, H), a (H,), b/c
    (B, S, N); y (B, S, H, P) in x's dtype.  The Pallas kernel
    (repro/kernels/ssd_scan.py) computes the same function chunk by chunk;
    the chunked form's cumulative log-decays cost it accuracy where Δ·A is
    large, the recurrence does not (PERF.md, PR 15)."""
    bs, s, h, p = x.shape
    decay = torch.exp(dt.float() * a.float())               # (B,S,H)
    xl = x.float() * dt.float()[..., None]                  # (B,S,H,P)
    b32, c32 = b.float(), c.float()
    state = torch.zeros(bs, h, p, b.shape[-1], device=x.device)
    y = torch.empty(bs, s, h, p, device=x.device)
    for t in range(s):
        state.mul_(decay[:, t, :, None, None]).add_(
            xl[:, t, :, :, None] * b32[:, t, None, None, :])
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, c32[:, t])
    return y.to(x.dtype)


def rglru_scan_ref(a, bx):
    """#17 h_t = a_t ⊙ h_{t−1} + bx_t from h_0 = 0 in f32
    (repro/kernels/rglru_scan.py), the product and the sum each rounded
    (the kernel rounds alike).  Returns (h (B, S, W) f32, h_last =
    h[:, −1])."""
    a32, b32 = a.float(), bx.float()
    h = torch.empty_like(b32)
    state = torch.zeros_like(b32[:, 0])
    for t in range(a.shape[1]):
        state = state * a32[:, t] + b32[:, t]
        h[:, t] = state
    return h, h[:, -1]
