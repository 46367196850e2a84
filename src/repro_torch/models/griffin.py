"""RG-LRU recurrent block, prefill (repro/models/griffin.py).

The Real-Gated Linear Recurrent Unit (Griffin / RecurrentGemma,
arXiv:2402.19427):

    r_t = σ(W_a x_t + b_a)                    recurrence gate
    i_t = σ(W_x x_t + b_x)                    input gate
    a_t = exp(−c · r_t · softplus(Λ))         input-dependent decay, c = 8
    h_t = a_t h_{t−1} + √(1 − a_t²) · (i_t · x_t)

The block: two d→width projections; branch 1 → GeLU; branch 2 → causal
conv1d (width 4) → RG-LRU; elementwise merge; width→d projection.  The
plain path (``use_pallas=False``) scans in log depth on tensors, as the
reference's ``jax.lax.associative_scan`` does; the kernel path runs
kernel #17 (:func:`repro_torch.kernels.ops.rglru_scan`).  Decode carries
an O(1) cache, the conv's last inputs and h, and takes one step of the
recurrence on the plain path.  Under a model group the block runs on the
rank's block of the width (:func:`rglru_block`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding import tp as tp_lib

__all__ = ["init_rglru_block", "rglru_block", "init_rglru_cache",
           "rglru_scan", "rglru_gates"]

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_gates(params: dict, x: torch.Tensor, *, tp=None,
                width: int | None = None):
    """(a, gated input) of the scan, both f32; x (B, S, W).  With a model
    group ``tp``, x is this rank's block of the ``width`` channels: the
    gates' projections are column-parallel on the whole x (gathered with
    ``gather_from``, whose backward sums the ranks' partial gradients),
    their biases and Λ cut to the block, and the gated input takes the
    local x."""
    xin, lam = x, params["lam"]
    w_a, w_x = params["w_a"], params["w_x"]
    if tp is not None:
        xin = tp_lib.gather_from(x, tp, -1)
        lam = tp_lib.weight_for(lam, (width,), tp, 0)
        w_a, w_x = ({"w": p["w"], "b": tp_lib.weight_for(p["b"], (width,),
                                                         tp, 0)}
                    for p in (w_a, w_x))
    r = torch.sigmoid(layers.dense(w_a, xin).float())
    i = torch.sigmoid(layers.dense(w_x, xin).float())
    log_a = -_C * r * F.softplus(lam.float())  # ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * x.float()


def rglru_scan(a: torch.Tensor, bx: torch.Tensor):
    """h_t = a_t h_{t−1} + bx_t from h_0 = 0 in log2(S) doubling steps
    (Hillis–Steele over the pairs (a, b) ∘ (a', b') = (a a', a' b + b')).

    Returns (h (B, S, W) f32, h_last (B, W) f32)."""
    a, h = a.float(), bx.float()
    s = a.shape[1]
    off = 1
    while off < s:
        h = torch.cat([h[:, :off], torch.addcmul(h[:, off:], a[:, off:],
                                                 h[:, :-off])], dim=1)
        if off * 2 < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h, h[:, -1]


def init_rglru_block(draws, d: int, width: int, dtype,
                     conv_width: int = 4) -> dict:
    # Λ so that the decays a^c land in (0.9, 0.999) (Griffin appendix A)
    u = 0.9 + 0.099 * draws.uniform((width,))
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {
        "proj_gelu": layers.init_dense(draws, (d, width), dtype),
        "proj_rec": layers.init_dense(draws, (d, width), dtype),
        "w_a": layers.init_dense(draws, (width, width), dtype, bias=True),
        "w_x": layers.init_dense(draws, (width, width), dtype, bias=True),
        "lam": lam.float(),
        "conv_w": (draws.normal((conv_width, width)) * 0.1).to(dtype),
        "conv_b": torch.zeros((width,), dtype=dtype, device=draws.device),
        "out_proj": layers.init_dense(draws, (width, d), dtype),
    }


def init_rglru_cache(batch: int, width: int, conv_width: int = 4,
                     dtype=torch.float32, *, device) -> dict:
    return {"conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, width), device=device)}


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                cache: torch.Tensor | None = None):
    """Depthwise causal conv1d: x (B, S, C), w (K, C), from the history
    ``cache`` (B, K − 1, C) (zeros when None); the taps are summed in the
    reference's order, in x's dtype.  Returns (y, the new history: the
    last K − 1 inputs, in x's dtype)."""
    k, s = w.shape[0], x.shape[1]
    if cache is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    return y + bias, xp[:, s:]


def rglru_block(params: dict, x: torch.Tensor, *, compute_dtype,
                cache: dict | None = None, use_pallas: bool = False,
                tp=None, width: int | None = None):
    """The Griffin recurrent block; x (B, S, d) → ((B, S, d), the new
    cache or None).  With ``cache`` x is one token (S = 1).

    With a model group ``tp`` (a prefill or training forward; ``width``
    the block's whole W) it runs on the rank's W/M channels, its leaves
    the rank's ``param_pspecs`` blocks: ``proj_gelu`` and ``proj_rec``
    column-parallel on one ``copy_to`` of x, the conv on ``conv_w``'s
    channel block (``conv_b`` cut to it), the gates (:func:`rglru_gates`)
    and the scan (#17 under ``use_pallas``) on the block, ``out_proj``
    row-parallel (``reduce_from``)."""
    conv_b = params["conv_b"]
    if tp is not None:
        if params["proj_rec"]["w"].shape[-1] * tp.size != width:
            raise NotImplementedError(
                f"tensor-parallel RG-LRU takes its width {width} over "
                f"{tp.size} model ranks from proj_rec's column block; got "
                f"{tuple(params['proj_rec']['w'].shape)}")
        x = tp_lib.copy_to(x, tp)
        conv_b = tp_lib.weight_for(conv_b, (width,), tp, 0)
    gate = layers.gelu(layers.dense(params["proj_gelu"], x,
                                    compute_dtype=compute_dtype))
    rec = layers.dense(params["proj_rec"], x, compute_dtype=compute_dtype)
    rec, new_conv = causal_conv(rec, params["conv_w"].to(compute_dtype),
                                conv_b.to(compute_dtype),
                                None if cache is None else cache["conv"])
    a, bx = rglru_gates(params, rec, tp=tp, width=width)
    new_cache = None
    if cache is not None:
        h_new = a[:, 0] * cache["h"] + bx[:, 0]
        h = h_new[:, None]
        new_cache = {"conv": new_conv, "h": h_new}
    elif use_pallas:
        from repro_torch.kernels import ops
        h, _ = ops.rglru_scan(a, bx)
    else:
        h, _ = rglru_scan(a, bx)
    y = h.to(compute_dtype) * gate
    return layers.dense(params["out_proj"], y, compute_dtype=compute_dtype,
                        tp=tp, parallel="row"), new_cache
