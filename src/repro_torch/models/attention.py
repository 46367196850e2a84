"""Grouped-query causal attention, prefill without a cache
(repro/models/attention.py), optionally windowed.

``impl='xla'`` is the plain path.  The reference scans over query chunks
(``_chunked_prefill``) to bound memory at long sequences, and falls back
to one dense block when the sequence does not divide the chunk; both give
the same numbers.  The port computes the one masked block: scores in f32
(the reference's ``preferred_element_type``), softmax, then the
probabilities cast to v's dtype for the PV product.  ``impl='pallas'``
routes the causal prefill through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, kernel #15), which keeps
the probabilities in f32: at bf16 the two paths differ by design.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers

__all__ = ["NEG_INF", "init_attention", "attention"]

NEG_INF = -1e30


def init_attention(draws, d: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, dtype) -> dict:
    return {
        "wq": layers.init_dense(draws, (d, num_heads, head_dim), dtype,
                                fan_in=d),
        "wk": layers.init_dense(draws, (d, num_kv_heads, head_dim), dtype,
                                fan_in=d),
        "wv": layers.init_dense(draws, (d, num_kv_heads, head_dim), dtype,
                                fan_in=d),
        "wo": layers.init_dense(draws, (num_heads, head_dim, d), dtype,
                                fan_in=num_heads * head_dim),
    }


def _attend_block(q, k, v, qpos, kpos, scale: float,
                  window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,Kv,hd) → (B,S,H,hd), causal by position and,
    for ``window`` > 0, limited to the last ``window`` keys."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    mask = kpos[..., None, :] <= qpos[..., :, None]               # (B,S,T)
    if window > 0:
        mask &= kpos[..., None, :] > qpos[..., :, None] - window
    scores = scores.mul_(scale).masked_fill_(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, h, v.shape[-1])


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              head_dim: int, window: int = 0, rope_kind: str = "rope",
              rope_theta: float = 10_000.0, compute_dtype=torch.float32,
              impl: str = "xla") -> torch.Tensor:
    """Causal GQA self-attention with RoPE; x (B, S, d) → (B, S, d)."""
    q = layers.dense(params["wq"], x, compute_dtype=compute_dtype)
    k = layers.dense(params["wk"], x, compute_dtype=compute_dtype)
    v = layers.dense(params["wv"], x, compute_dtype=compute_dtype)
    if rope_kind == "rope":
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    elif rope_kind != "none":
        raise ValueError(f"unknown rope kind {rope_kind!r}")
    scale = head_dim ** -0.5
    if impl == "pallas":
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, k, v, window=window, scale=scale)
    else:
        out = _attend_block(q, k, v, positions, positions, scale, window)
    out = out.to(compute_dtype)
    return torch.einsum("bshd,hdo->bso", out,
                        params["wo"]["w"].to(compute_dtype))
