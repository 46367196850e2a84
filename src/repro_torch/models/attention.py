"""Grouped-query causal attention for training (repro/models/attention.py,
prefill with ``impl='xla'``, no cache).

The reference's training forward scans over query chunks
(``_chunked_prefill``) to bound memory at long sequences, and falls back
to one dense block when the sequence does not divide the chunk; both give
the same numbers.  The port computes the one masked block: scores in f32,
softmax, then the probabilities cast to v's dtype for the PV product.
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


def _attend_block(q, k, v, qpos, kpos, scale: float) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,Kv,hd) → (B,S,H,hd), causal by position."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    mask = kpos[..., None, :] <= qpos[..., :, None]               # (B,S,T)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, h, v.shape[-1])


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              head_dim: int, rope_theta: float = 10_000.0,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Causal GQA self-attention with RoPE; x (B, S, d) → (B, S, d)."""
    q = layers.dense(params["wq"], x, compute_dtype=compute_dtype)
    k = layers.dense(params["wk"], x, compute_dtype=compute_dtype)
    v = layers.dense(params["wv"], x, compute_dtype=compute_dtype)
    q = layers.apply_rope(q, positions, rope_theta)
    k = layers.apply_rope(k, positions, rope_theta)
    out = _attend_block(q, k, v, positions, positions, head_dim ** -0.5)
    out = out.to(compute_dtype)
    return torch.einsum("bshd,hdo->bso", out,
                        params["wo"]["w"].to(compute_dtype))
