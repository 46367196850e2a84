"""Multi-head Latent Attention (repro/models/mla.py; DeepSeek-V2 §2.1,
DeepSeek-V3 §2.1.1).

MLA compresses K/V into a low-rank latent c_kv (``kv_lora_rank`` wide) plus
one RoPE key head shared by all heads; per-head keys and values are
up-projections of the latent.  The decode cache stores only (latent,
k_rope).

Prefill expands K/V from the latent, pads V to the QK head dim and
attends on the plain path over query chunks (models/attention.py's
chunked prefill, always, as the reference's MLA always scans), whatever
``impl`` says: an MLA layer launches no kernel.  Decode runs the
**absorbed** form, attending entirely in latent space:

    score_t = q_nopeᵀ W_ukᵀ c_t + q_ropeᵀ k_rope_t
            = (W_uk q_nope)ᵀ c_t + …        (absorb W_uk into the query)
    out     = W_uv Σ_t p_t c_t              (absorb W_uv into the output)

with the scores in f32 and the new (latent, k_rope) written into slot
``index % cache_len`` out of place through a tensor comparison, as
``attention._decode`` writes its KV cache: no host read, so the step runs
under ``torch.func.vmap``.

Under a model group (``tp``, sharding/tp.py) the prefill is
tensor-parallel on the heads, as ``sharding.param_pspecs`` places the
weights: x enters through ``copy_to``; ``wq`` (or ``wq_b``), ``wk_b`` and
``wv_b`` are this rank's column blocks of the heads; ``wq_a``, ``wkv_a``
and the norms stay replicated and are taken through ``copy_to`` (their
gradients, partial on each rank, are summed over the group); the chunked
prefill runs on the local heads, and ``wo``'s row block ends in
``reduce_from``.  The absorbed decode is one-device (ROADMAP.md Queue A
item 6.5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.sharding import tp as tp_lib

__all__ = ["init_mla", "mla_attention", "init_mla_cache"]


def init_mla(draws, d: int, num_heads: int, cfg: MLAConfig, dtype) -> dict:
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = layers.init_dense(draws, (d, cfg.q_lora_rank), dtype)
        p["q_norm"] = layers.init_rms_norm(cfg.q_lora_rank, dtype,
                                           draws.device)
        p["wq_b"] = layers.init_dense(
            draws, (cfg.q_lora_rank, num_heads, qk_dim), dtype,
            fan_in=cfg.q_lora_rank)
    else:
        p["wq"] = layers.init_dense(draws, (d, num_heads, qk_dim), dtype,
                                    fan_in=d)
    p["wkv_a"] = layers.init_dense(
        draws, (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype)
    p["kv_norm"] = layers.init_rms_norm(cfg.kv_lora_rank, dtype,
                                        draws.device)
    p["wk_b"] = layers.init_dense(
        draws, (cfg.kv_lora_rank, num_heads, cfg.qk_nope_head_dim), dtype,
        fan_in=cfg.kv_lora_rank)
    p["wv_b"] = layers.init_dense(
        draws, (cfg.kv_lora_rank, num_heads, cfg.v_head_dim), dtype,
        fan_in=cfg.kv_lora_rank)
    p["wo"] = layers.init_dense(
        draws, (num_heads, cfg.v_head_dim, d), dtype,
        fan_in=num_heads * cfg.v_head_dim)
    return p


def init_mla_cache(batch: int, cache_len: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, *, device) -> dict:
    """Empty latent cache.  ``positions`` = -1 marks unfilled slots."""
    return {
        "latent": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                device=device),
        "index": torch.zeros((), dtype=torch.int32, device=device),
    }


def _project_q(params, x, cfg: MLAConfig, compute_dtype):
    if "wq_a" in params:
        ql = layers.dense(params["wq_a"], x, compute_dtype=compute_dtype)
        ql = layers.rms_norm(params["q_norm"], ql)
        q = layers.dense(params["wq_b"], ql, compute_dtype=compute_dtype)
    else:
        q = layers.dense(params["wq"], x, compute_dtype=compute_dtype)
    return torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                       dim=-1)                                # nope, rope


def _project_latent(params, x, cfg: MLAConfig, compute_dtype):
    kv = layers.dense(params["wkv_a"], x, compute_dtype=compute_dtype)
    latent, k_rope = torch.split(
        kv, [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    latent = layers.rms_norm(params["kv_norm"], latent)
    return latent, k_rope  # (B,S,rank), (B,S,rope_dim)


def _decode(params, q_nope, q_rope, latent, k_rope, cache: dict, pos_now,
            scale: float, window: int, compute_dtype):
    """The absorbed decode of one query token against the latent cache
    with (latent, k_rope) stored at its slot: (B,1,H,v) and the new
    cache."""
    s_cache = cache["latent"].shape[1]
    slot = torch.arange(s_cache, device=latent.device) == \
        cache["index"] % s_cache
    lc = torch.where(slot[None, :, None],
                     latent.to(cache["latent"].dtype), cache["latent"])
    rc = torch.where(slot[None, :, None],
                     k_rope.to(cache["k_rope"].dtype), cache["k_rope"])
    posc = torch.where(slot, pos_now.to(torch.int32), cache["positions"])
    new_cache = {"latent": lc, "k_rope": rc, "positions": posc,
                 "index": cache["index"] + 1}
    # absorb W_uk into the query: (B,1,H,nope) @ (rank,H,nope) → latent dim
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                         params["wk_b"]["w"].to(compute_dtype))
    scores = torch.einsum("bshr,btr->bhst", q_lat.float(),
                          lc.to(compute_dtype).float())
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                   rc.to(compute_dtype).float())
    scores = scores * scale
    valid = (posc >= 0) & (posc <= pos_now)
    if window > 0:
        valid &= posc > pos_now - window
    scores = scores.masked_fill(~valid, attn.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, lc.float())
    # absorb W_uv into the output
    out = torch.einsum("bshr,rhv->bshv", ctx.to(compute_dtype),
                       params["wv_b"]["w"].to(compute_dtype))
    return out, new_cache


def _tp_params(params: dict, d: int, num_heads: int, cfg: MLAConfig,
               tp) -> dict:
    """The weights as the tensor-parallel prefill uses them: the head
    blocks as they are, the replicated ones through ``copy_to``."""
    if num_heads % tp.size:
        raise NotImplementedError(
            f"tensor-parallel MLA with {num_heads} heads over {tp.size} "
            f"model ranks")
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    full = {"wq": ((d, num_heads, qk), 1),
            "wq_a": ((d, cfg.q_lora_rank), None),
            "wq_b": ((cfg.q_lora_rank, num_heads, qk), 1),
            "wkv_a": ((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), None),
            "wk_b": ((cfg.kv_lora_rank, num_heads, cfg.qk_nope_head_dim), 1),
            "wv_b": ((cfg.kv_lora_rank, num_heads, cfg.v_head_dim), 1),
            "wo": ((num_heads, cfg.v_head_dim, d), 0)}
    out = {}
    for name, p in params.items():
        if name in full:
            shape, part = full[name]
            out[name] = {"w": tp_lib.weight_for(p["w"], shape, tp, part)}
        else:                                    # q_norm, kv_norm
            out[name] = {"scale": tp_lib.copy_to(p["scale"], tp)}
    return out


def mla_attention(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  cfg: MLAConfig,
                  rope_theta: float = 10_000.0, window: int = 0,
                  cache: dict | None = None,
                  compute_dtype=torch.bfloat16, tp=None,
                  num_heads: int | None = None):
    """MLA on x (B, S, d), positions (B, S): prefill without ``cache``,
    the absorbed decode with it; with a model group ``tp`` (and the
    global ``num_heads``) the tensor-parallel prefill of the module
    docstring.  Returns (y (B, S, d), the new cache or None)."""
    if tp is not None:
        if cache is not None:
            raise NotImplementedError(
                "tensor-parallel MLA decode is not ported (ROADMAP.md "
                "Queue A item 6.5)")
        params = _tp_params(params, x.shape[-1], num_heads, cfg, tp)
        x = tp_lib.copy_to(x, tp)
    q_nope, q_rope = _project_q(params, x, cfg, compute_dtype)
    q_rope = layers.apply_rope(q_rope, positions, rope_theta)
    latent, k_rope = _project_latent(params, x, cfg, compute_dtype)
    # the single rope key head, shared by every query head
    k_rope = layers.apply_rope(k_rope[..., None, :], positions,
                               rope_theta)[..., 0, :]
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5

    if cache is None:
        # ---- prefill: per-head K/V expanded from the latent ---------------
        k_nope = layers.dense(params["wk_b"], latent,
                              compute_dtype=compute_dtype)  # (B,S,H,nope)
        v = layers.dense(params["wv_b"], latent,
                         compute_dtype=compute_dtype)       # (B,S,H,vdim)
        k_rope_h = k_rope[:, :, None, :].expand(
            k_nope.shape[:3] + (cfg.qk_rope_head_dim,))
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        # V padded to the QK head dim, as the reference pads it for its
        # GQA path, then sliced back (vdim ≤ qk_dim in DeepSeek's configs)
        v_pad = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
        out = attn._chunked_prefill(q, k, v_pad, positions, positions,
                                    scale, window)[..., :cfg.v_head_dim]
        new_cache = None
    else:
        out, new_cache = _decode(params, q_nope, q_rope, latent, k_rope,
                                 cache, positions[0, -1], scale, window,
                                 compute_dtype)
    y = torch.einsum("bshv,hvo->bso", out.to(compute_dtype),
                     params["wo"]["w"].to(compute_dtype))
    if tp is not None:
        y = tp_lib.reduce_from(y, tp)
    return y, new_cache
