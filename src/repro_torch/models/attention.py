"""Grouped-query attention with causal / sliding-window masking and a KV
cache (repro/models/attention.py).

Prefill (``cache=None``): ``impl='xla'`` is the plain path.  The
reference scans over query chunks (``_chunked_prefill``) to bound memory
at long sequences, and falls back to one dense block when the sequence
does not divide the chunk; both give the same numbers.  The port
computes the one masked block: scores in f32 (the reference's
``preferred_element_type``), softmax, then the probabilities cast to v's
dtype for the PV product.  ``impl='pallas'`` routes the causal prefill
through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, kernel #15), which keeps
the probabilities in f32: at bf16 the two paths differ by design.

Cross-attention (the encoder-decoder's decoder, ``kv_override``): K and V
are projected from the encoder memory, no rope is applied to q or k and
no mask limits the keys.  The encoder's self-attention is not causal
(``causal=False``).  Only a causal self-attention reaches kernel #15; the
others run the plain path under either ``impl``, as in the reference.

Decode (``cache`` given): one query token against a (possibly rolling)
cache, on the plain path whatever ``impl`` says, as the reference
decodes.  The cache stores per-slot absolute positions (-1: empty), so
one mask covers full caches, sliding windows and the ring buffer of the
``long_variant`` window.  The new k/v go into slot ``index % cache_len``
out of place, selected by a tensor comparison: no host read, so the step
runs under ``torch.func.vmap`` (personalized serving, launch/serve.py).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers

__all__ = ["NEG_INF", "init_attention", "init_cache", "attention"]

NEG_INF = -1e30


def init_attention(draws, d: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, dtype, bias: bool = False) -> dict:
    return {
        "wq": layers.init_dense(draws, (d, num_heads, head_dim), dtype,
                                fan_in=d, bias=bias),
        "wk": layers.init_dense(draws, (d, num_kv_heads, head_dim), dtype,
                                fan_in=d, bias=bias),
        "wv": layers.init_dense(draws, (d, num_kv_heads, head_dim), dtype,
                                fan_in=d, bias=bias),
        "wo": layers.init_dense(draws, (num_heads, head_dim, d), dtype,
                                fan_in=num_heads * head_dim),
    }


def init_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, *, device) -> dict:
    """Empty KV cache.  ``positions`` = -1 marks unfilled slots."""
    return {
        "k": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _scores(q, k) -> torch.Tensor:
    """q (B,S,H,hd), k (B,T,Kv,hd) → f32 scores (B,Kv,G,S,T)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())


def _out(probs, v) -> torch.Tensor:
    """probs (B,Kv,G,S,T) cast to v's dtype, times v (B,T,Kv,hd) →
    (B,S,H,hd)."""
    b, kv, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, kv * g, v.shape[-1])


def _attend_block(q, k, v, qpos, kpos, scale: float, window: int = 0,
                  causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,Kv,hd) → (B,S,H,hd); with ``causal``, masked
    causally by position and, for ``window`` > 0, limited to the last
    ``window`` keys; without, every key is seen."""
    scores = _scores(q, k).mul_(scale)
    if causal:
        mask = kpos[..., None, :] <= qpos[..., :, None]           # (B,S,T)
        if window > 0:
            mask &= kpos[..., None, :] > qpos[..., :, None] - window
        scores = scores.masked_fill_(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    return _out(probs, v)


def _decode(q, k, v, cache: dict, pos_now, scale: float, window: int,
            compute_dtype):
    """One query against the cache with (k, v) stored at its slot: the
    attention output (B,1,H,hd) and the new cache."""
    s_cache = cache["k"].shape[1]
    slot = torch.arange(s_cache, device=q.device) == cache["index"] % s_cache
    kc = torch.where(slot[None, :, None, None], k.to(cache["k"].dtype),
                     cache["k"])
    vc = torch.where(slot[None, :, None, None], v.to(cache["v"].dtype),
                     cache["v"])
    posc = torch.where(slot, pos_now.to(torch.int32), cache["positions"])
    new_cache = {"k": kc, "v": vc, "positions": posc,
                 "index": cache["index"] + 1}
    scores = _scores(q, kc.to(compute_dtype)) * scale
    valid = (posc >= 0) & (posc <= pos_now)
    if window > 0:
        valid &= posc > pos_now - window
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _out(probs, vc.to(compute_dtype)), new_cache


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              head_dim: int, window: int = 0, rope_kind: str = "rope",
              rope_theta: float = 10_000.0, mrope_positions=None,
              cache: dict | None = None, kv_override=None,
              causal: bool = True, compute_dtype=torch.float32,
              impl: str = "xla"):
    """GQA attention of x (B, S, d) at positions (B, S): self-attention
    with RoPE (M-RoPE at ``mrope_positions`` (3, B, S)), causal unless
    ``causal`` is False, or with ``kv_override`` (B, T, d) the
    cross-attention to that encoder memory.

    Returns (out (B, S, d), the updated cache or None)."""
    q = layers.dense(params["wq"], x, compute_dtype=compute_dtype)
    kv_src = x if kv_override is None else kv_override
    k = layers.dense(params["wk"], kv_src, compute_dtype=compute_dtype)
    v = layers.dense(params["wv"], kv_src, compute_dtype=compute_dtype)
    if kv_override is None:
        if rope_kind == "rope":
            q = layers.apply_rope(q, positions, rope_theta)
            k = layers.apply_rope(k, positions, rope_theta)
        elif rope_kind == "mrope":
            if mrope_positions is None:
                raise ValueError("rope_kind='mrope' needs mrope_positions")
            q = layers.apply_mrope(q, mrope_positions, rope_theta)
            k = layers.apply_mrope(k, mrope_positions, rope_theta)
        elif rope_kind != "none":
            raise ValueError(f"unknown rope kind {rope_kind!r}")
    scale = head_dim ** -0.5
    new_cache = None
    is_causal = causal and kv_override is None
    if cache is not None:
        if kv_override is not None:
            raise ValueError("cross-attention takes no cache")
        out, new_cache = _decode(q, k, v, cache, positions[0, -1], scale,
                                 window, compute_dtype)
    elif impl == "pallas" and is_causal:
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, k, v, window=window, scale=scale)
    else:
        # under kv_override the keys sit at 0 .. T-1; no mask reads them
        out = _attend_block(q, k, v, positions, positions, scale, window,
                            is_causal)
    out = out.to(compute_dtype)
    return torch.einsum("bshd,hdo->bso", out,
                        params["wo"]["w"].to(compute_dtype)), new_cache
