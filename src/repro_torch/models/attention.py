"""Grouped-query attention with causal / sliding-window masking and a KV
cache (repro/models/attention.py).

Prefill (``cache=None``): ``impl='xla'`` is the plain path, a masked
block of scores in f32 (the reference's ``preferred_element_type``),
softmax, then the probabilities cast to v's dtype for the PV product.
With ``chunked_prefill`` (the config's ``attn_chunked_prefill``, on by
default) it runs, as the reference's ``_chunked_prefill`` does, over
query chunks of 512: each chunk's (B, H, 512, T) block in place of the
whole (B, H, S, T) one, its mask rebuilt from the chunk's offset
(``q0 + arange(512)`` against ``arange(T)``), its body rematerialised
(models/remat.py) so that a backward recomputes the chunk's
probabilities; a sequence that 512 does not divide takes the one block.
``impl='pallas'`` routes the causal prefill through the flash-attention
kernel (:func:`repro_torch.kernels.ops.flash_attention`, kernel #15),
which keeps the probabilities in f32: at bf16 the two paths differ by
design.

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

Tensor-parallel prefill (``tp``, a sharding.tp.ModelGroup of M > 1
ranks; training and prefill, not decode), in the three layouts of the
reference's ``_tp_preferences``:

  (a) the KV heads divide M: each rank attends its H/M query heads and
      KV/M key heads (wq, wk, wv and wo's blocks are head blocks); x
      enters through ``copy_to`` and wo's partial outputs are summed by
      ``reduce_from``;
  (b) GQA whose KV heads do not divide M: the query heads are
      partitioned as in (a), wk and wv are replicated and taken through
      ``copy_to`` (their gradients, partial on each rank, are summed),
      and each rank's query heads read their GLOBAL KV heads (query head
      h reads KV head h // (H / KV), which the local shapes' grouping
      would not give);
  (c) the heads do not divide M (``weight_gather``, the reference's
      ``attn_weight_gather``): the weights are gathered on use
      (``gather_from``: d-sharded wq/wk/wv and wo's d-column block) and
      the sequence is split instead, as the reference constrains q, k, v
      to the model axis: each rank projects its S/M positions, the keys
      and values are gathered over the sequence, its queries attend all
      of them, and the zero-padded outputs are summed by ``reduce_from``.
      The sequence must divide M.

The chunked prefill runs on the rank's local heads; in (c) its chunks
cut the rank's S/M queries at their true offsets in the sequence.
M-RoPE (Qwen2-VL) rotates the local heads as RoPE does: its sections run
over the head dim, so a block of heads keeps them; in (c) the rank's
``mrope_positions`` are its S/M positions.

The cross-attention under a model group takes layout (a) or (b): q from
the decoder's x and k, v from the encoder memory, each through its own
``copy_to`` (every rank's heads read the whole memory, and the memory's
gradient, partial on each rank, is summed over the group), unmasked on
the plain path, wo row-parallel into ``reduce_from``.  A cross-attention
whose heads the group does not divide raises NotImplementedError (no
config has one).

A bias ((heads, hd), which ``param_pspecs`` shards on hd) is gathered on
use and cut to the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models import remat
from repro_torch.sharding import tp as tp_lib

__all__ = ["NEG_INF", "PREFILL_CHUNK", "init_attention", "init_cache",
           "attention"]

NEG_INF = -1e30
PREFILL_CHUNK = 512


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


def _chunked_prefill(q, k, v, qpos, kpos, scale: float, window: int = 0,
                     causal: bool = True, *, q_offset: int = 0,
                     s_total: int | None = None) -> torch.Tensor:
    """:func:`_attend_block` over query chunks of PREFILL_CHUNK (the
    reference's ``_chunked_prefill``, repro/models/attention.py:101-160):
    one dense block on the given positions when the sequence of
    ``s_total`` queries (default: q's) does not divide the chunk; else
    each chunk of q's rows masked by its own positions ``q_offset + lo +
    arange`` against ``arange(T)`` (the queries in sequence order, q the
    rows from ``q_offset`` on), its body rematerialised."""
    s, chunk = q.shape[1], PREFILL_CHUNK
    if (s if s_total is None else s_total) % chunk:
        return _attend_block(q, k, v, qpos, kpos, scale, window, causal)
    t = k.shape[1]

    def body(qi, k, v, q0):
        c = qi.shape[1]
        qpos_i = (q0 + torch.arange(c, device=qi.device))[None]
        kpos_i = torch.arange(t, device=qi.device)[None]
        return (_attend_block(qi, k, v, qpos_i, kpos_i, scale, window,
                              causal),)

    return torch.cat([remat.checkpoint(body, q[:, lo:lo + chunk], k, v,
                                       q_offset + lo)[0]
                      for lo in range(0, s, chunk)], dim=1)


def _prefill(q, k, v, qpos, kpos, scale: float, window: int,
             causal: bool, chunked: bool, **kw) -> torch.Tensor:
    """The plain prefill: chunked (:func:`_chunked_prefill`) or one
    block."""
    if chunked:
        return _chunked_prefill(q, k, v, qpos, kpos, scale, window, causal,
                                **kw)
    return _attend_block(q, k, v, qpos, kpos, scale, window, causal)


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


def _rope(t, positions, mrope_positions, rope_kind: str, theta: float):
    """RoPE at ``positions`` (B, S), M-RoPE at ``mrope_positions`` (3, B,
    S), or none, on t (B, S, H, hd)."""
    if rope_kind == "rope":
        return layers.apply_rope(t, positions, theta)
    if rope_kind == "mrope":
        if mrope_positions is None:
            raise ValueError("rope_kind='mrope' needs mrope_positions")
        return layers.apply_mrope(t, mrope_positions, theta)
    if rope_kind != "none":
        raise ValueError(f"unknown rope kind {rope_kind!r}")
    return t


def _tp_attention(params: dict, x, positions, tp, *, num_heads: int,
                  num_kv_heads: int, head_dim: int, weight_gather: bool,
                  window: int, rope_kind: str, rope_theta: float,
                  mrope_positions, kv_override, causal: bool,
                  compute_dtype, impl: str, chunked: bool):
    """Tensor-parallel attention over the model group ``tp`` (the module
    docstring's layouts (a)–(c)): self-attention with RoPE or M-RoPE, or
    with ``kv_override`` (B, T, d) the cross-attention to that memory in
    (a) or (b); x (B, S, d) and the memory replicated, the output (B, S,
    d) replicated."""
    d = x.shape[-1]
    cdt = compute_dtype

    def proj(name, n_heads, src, heads_part):
        p = params[name]
        w = tp_lib.weight_for(p["w"], (d, n_heads, head_dim), tp,
                              1 if heads_part else None)
        y = torch.tensordot(src.to(cdt), w.to(cdt), dims=1)
        if "b" in p:
            b = tp_lib.weight_for(p["b"], (n_heads, head_dim), tp,
                                  0 if heads_part else None)
            y = y + b.to(y.dtype)
        return y

    scale = head_dim ** -0.5
    wo_full = (num_heads, head_dim, d)
    if num_heads % tp.size and kv_override is not None:
        raise NotImplementedError(
            f"a tensor-parallel cross-attention whose heads the model "
            f"group does not divide ({num_heads} over {tp.size}) is not "
            f"ported: the memory's keys would need the sequence split")
    if kv_override is None and (weight_gather or num_heads % tp.size):
        # (c): the sequence split over the group, the weights gathered
        s = x.shape[1]
        if s % tp.size:
            raise ValueError(
                f"tensor-parallel attention with heads that do not divide "
                f"the model group ({num_heads} over {tp.size}) splits the "
                f"sequence, which must divide it too (S = {s})")
        c = s // tp.size
        lo = tp.rank * c
        xs = tp_lib.copy_to(x, tp)[:, lo:lo + c]
        ps = positions[..., lo:lo + c]
        mps = None if mrope_positions is None \
            else mrope_positions[..., lo:lo + c]
        q = _rope(proj("wq", num_heads, xs, False), ps, mps, rope_kind,
                  rope_theta)
        k = _rope(proj("wk", num_kv_heads, xs, False), ps, mps, rope_kind,
                  rope_theta)
        v = proj("wv", num_kv_heads, xs, False)
        k, v = tp_lib.gather_from(k, tp, 1), tp_lib.gather_from(v, tp, 1)
        out = _prefill(q, k, v, ps, positions, scale, window, causal,
                       chunked, q_offset=lo, s_total=s)
        wo = tp_lib.weight_for(params["wo"]["w"], wo_full, tp)
        y = torch.einsum("bshd,hdo->bso", out.to(cdt), wo.to(cdt))
        return tp_lib.reduce_from(F.pad(y, (0, 0, lo, s - lo - c)), tp)
    # (a) and (b): the query heads split over the group; a cross-
    # attention's memory enters through its own copy_to, so that the
    # memory's gradient, partial on each rank, is summed
    xc = tp_lib.copy_to(x, tp)
    src = xc if kv_override is None else tp_lib.copy_to(kv_override, tp)
    kv_part = num_kv_heads % tp.size == 0
    q = proj("wq", num_heads, xc, True)
    k = proj("wk", num_kv_heads, src, kv_part)
    v = proj("wv", num_kv_heads, src, kv_part)
    if kv_override is None:
        q = _rope(q, positions, mrope_positions, rope_kind, rope_theta)
        k = _rope(k, positions, mrope_positions, rope_kind, rope_theta)
    if not kv_part:
        # (b): every local query head reads its global KV head
        hl = q.shape[-2]
        heads = torch.arange(tp.rank * hl, (tp.rank + 1) * hl,
                             device=q.device)
        kv = heads // (num_heads // num_kv_heads)
        k, v = k.index_select(-2, kv), v.index_select(-2, kv)
    is_causal = causal and kv_override is None
    if impl == "pallas" and is_causal:
        from repro_torch.kernels import ops
        out = ops.flash_attention(q, k, v, window=window, scale=scale)
    else:
        out = _prefill(q, k, v, positions, positions, scale, window,
                       is_causal, chunked)
    wo = tp_lib.weight_for(params["wo"]["w"], wo_full, tp, 0)
    y = torch.einsum("bshd,hdo->bso", out.to(cdt), wo.to(cdt))
    return tp_lib.reduce_from(y, tp)


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
              head_dim: int, window: int = 0, rope_kind: str = "rope",
              rope_theta: float = 10_000.0, mrope_positions=None,
              cache: dict | None = None, kv_override=None,
              causal: bool = True, compute_dtype=torch.float32,
              impl: str = "xla", tp=None, num_heads: int | None = None,
              num_kv_heads: int | None = None,
              weight_gather: bool = False, chunked_prefill: bool = True):
    """GQA attention of x (B, S, d) at positions (B, S): self-attention
    with RoPE (M-RoPE at ``mrope_positions`` (3, B, S)), causal unless
    ``causal`` is False, or with ``kv_override`` (B, T, d) the
    cross-attention to that encoder memory.  A prefill that reaches no
    kernel runs over query chunks with ``chunked_prefill``.  With a model
    group ``tp`` (and the global ``num_heads``/``num_kv_heads``) the
    tensor-parallel self- or cross-attention of the module docstring.

    Returns (out (B, S, d), the updated cache or None)."""
    if tp is not None:
        if cache is not None:
            raise NotImplementedError(
                "tensor-parallel attention covers training and prefill; "
                "decode caches (ROADMAP.md Queue A item 6.5) are not "
                "ported")
        return _tp_attention(
            params, x, positions, tp, num_heads=num_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            weight_gather=weight_gather, window=window,
            rope_kind=rope_kind, rope_theta=rope_theta,
            mrope_positions=mrope_positions, kv_override=kv_override,
            causal=causal, compute_dtype=compute_dtype, impl=impl,
            chunked=chunked_prefill), None
    q = layers.dense(params["wq"], x, compute_dtype=compute_dtype)
    kv_src = x if kv_override is None else kv_override
    k = layers.dense(params["wk"], kv_src, compute_dtype=compute_dtype)
    v = layers.dense(params["wv"], kv_src, compute_dtype=compute_dtype)
    if kv_override is None:
        q = _rope(q, positions, mrope_positions, rope_kind, rope_theta)
        k = _rope(k, positions, mrope_positions, rope_kind, rope_theta)
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
        out = _prefill(q, k, v, positions, positions, scale, window,
                       is_causal, chunked_prefill)
    out = out.to(compute_dtype)
    return torch.einsum("bshd,hdo->bso", out,
                        params["wo"]["w"].to(compute_dtype)), new_cache
