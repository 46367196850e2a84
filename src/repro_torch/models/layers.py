"""Building blocks of the port's language model (repro/models/layers.py).

Parameters are nested dicts of tensors in the reference's layout: dense
weights (in, out); q/k/v projections (d, heads, head_dim); the output
projection (heads, head_dim, d).  Normalisation math runs in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["init_rms_norm", "rms_norm", "init_layer_norm", "layer_norm",
           "init_dense", "dense", "gelu", "init_mlp", "mlp", "init_embedding",
           "embed", "unembed", "rope_frequencies", "apply_rope"]


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    """x / rms(x) · (1 + scale), in f32 (the reference's 1+scale form)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dtype)


def init_layer_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    """(x − mean) / sqrt(var + eps) · scale + bias, in f32 (the biased
    variance, as ``jnp.var``)."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


def init_dense(draws, shape: tuple, dtype, fan_in: int | None = None,
               bias: bool = False):
    """Truncated normal in [-2, 2] over sqrt(fan_in) (first dim default);
    ``bias`` adds a zero bias ``b`` of shape ``shape[1:]``.  Scaled in
    place: a weight costs its own bytes once at init."""
    fan = fan_in if fan_in is not None else shape[0]
    w = draws.truncated_normal(shape).div_(math.sqrt(fan))
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(shape[1:], dtype=dtype, device=draws.device)
    return p


def dense(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """x @ w (+ b) contracting x's last dim with w's first (w may be
    (d, H, hd)).  Without ``compute_dtype`` the operands are promoted to
    a common dtype, as the reference's mixed-dtype dot_general does."""
    w = params["w"]
    dtype = compute_dtype if compute_dtype is not None else \
        torch.promote_types(x.dtype, w.dtype)
    y = torch.tensordot(x.to(dtype), w.to(dtype), dims=1)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Nemotron's MLP)."""
    return torch.square(F.relu(x))


_GATES = {"swiglu": F.silu, "geglu": gelu}
_ACTS = {"relu2": relu2, "gelu": gelu}


def init_mlp(draws, d: int, d_ff: int, dtype, kind: str = "swiglu") -> dict:
    """wi, wg, wo for the gated kinds (swiglu, geglu); wi, wo for relu2
    and gelu."""
    if kind in _GATES:
        return {"wi": init_dense(draws, (d, d_ff), dtype),
                "wg": init_dense(draws, (d, d_ff), dtype),
                "wo": init_dense(draws, (d_ff, d), dtype)}
    return {"wi": init_dense(draws, (d, d_ff), dtype),
            "wo": init_dense(draws, (d_ff, d), dtype)}


def mlp(params: dict, x: torch.Tensor, kind: str = "swiglu",
        compute_dtype=None) -> torch.Tensor:
    """SwiGLU (silu(x wg) * x wi) wo or GeGLU with gelu for silu;
    squared-ReLU relu(x wi)² wo or GELU gelu(x wi) wo."""
    if kind not in _GATES and kind not in _ACTS:
        raise ValueError(f"unknown mlp kind {kind!r}")
    h = dense(params["wi"], x, compute_dtype=compute_dtype)
    if kind in _GATES:
        h = _GATES[kind](dense(params["wg"], x,
                               compute_dtype=compute_dtype)) * h
    else:
        h = _ACTS[kind](h)
    return dense(params["wo"], h, compute_dtype=compute_dtype)


def init_embedding(draws, vocab: int, d: int, dtype) -> dict:
    return {"table": draws.normal((vocab, d)).mul_(0.02).to(dtype)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype=None):
    tbl = params["table"]
    if compute_dtype is not None:
        tbl = tbl.to(compute_dtype)
    return F.embedding(tokens, tbl)


def unembed(params: dict, x: torch.Tensor, compute_dtype=None):
    """Logits via the untied output head; params = {'w': (d, vocab)}."""
    return dense(params, x, compute_dtype=compute_dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim (f32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """RoPE on (..., S, H, hd) with (..., S) positions: the head dim is
    split in halves (x1, x2) rotated by position · inv_freq, in f32."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, device=x.device)
    angles = positions.float()[..., None] * inv          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
