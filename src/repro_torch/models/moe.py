"""Mixture-of-Experts layer (repro/models/moe.py): DeepSeekMoE-style,
shared + routed experts, token-choice top-k routing with an expert
capacity.

  * router top-k over E experts in f32 (softmax probabilities, the top-k
    weights renormalised);
  * each routed copy's rank within its expert from a stable sort (no
    (N, E, C) one-hot dispatch tensor);
  * the kept copies scattered into an (E·C, d) buffer at ``e·C + rank``
    (``index_add``), the experts run as three batched matmuls over E,
    their outputs gathered back at the same index (``index_select``) and
    combined with the routing weights; copies of rank ≥ C are dropped
    (their residual path carries them);
  * the shared experts as one always-on SwiGLU MLP of width S·f.

Every buffer slot receives at most one kept copy, and the dropped ones
add exact zeros to slot 0 of their expert, so the scatter is
deterministic even where ``index_add`` runs on atomics.  Nothing is read
back to the host (the capacity comes from the input's shape), and every
op has a ``torch.func.vmap`` batching rule: the engines vmap
``Model.grad_fn`` over every agent row.

The auxiliary load-balance loss is the switch-style E·Σ f_e·p̄_e.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers

__all__ = ["init_moe", "moe_layer", "expert_capacity"]


def expert_capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = math.ceil(num_tokens * cfg.top_k / cfg.num_experts
                  * cfg.capacity_factor)
    return max(1, min(num_tokens, c))


def init_moe(draws, d: int, cfg: MoEConfig, dtype) -> dict:
    e, f = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": layers.init_dense(draws, (d, e), torch.float32),
        "wi": layers.init_dense(draws, (e, d, f), dtype, fan_in=d),
        "wg": layers.init_dense(draws, (e, d, f), dtype, fan_in=d),
        "wo": layers.init_dense(draws, (e, f, d), dtype, fan_in=f),
    }
    if cfg.num_shared:
        p["shared"] = layers.init_mlp(draws, d, cfg.num_shared * f, dtype,
                                      "swiglu")
    return p


def _rank_within_expert(flat_expert: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """rank[i] = #{j : expert[j] == expert[i], j < i}: a stable sort by
    expert id, each segment's start subtracted, scattered back to the
    original order."""
    nk = flat_expert.shape[0]
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=flat_expert.device).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert))
    seg_start = torch.cumsum(counts, 0) - counts                # (E,)
    rank_sorted = torch.arange(nk, device=flat_expert.device) - \
        seg_start.gather(0, sorted_expert)
    return torch.zeros_like(flat_expert).scatter(0, order, rank_sorted)


def _route(router: dict, tokens: torch.Tensor, top_k: int):
    """(probs (N, E), the top-k experts (N, k), their renormalised
    weights (N, k)) of tokens (N, d), in f32."""
    probs = torch.softmax(layers.dense(router, tokens.float()), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    return probs, top_e, top_p / (top_p.sum(-1, keepdim=True) + 1e-9)


def moe_layer(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
              compute_dtype=torch.bfloat16,
              capacity: int | None = None):
    """The MoE block on x (B, S, d); ``capacity`` overrides the one of
    ``capacity_factor``.  Returns (out (B, S, d), the f32 aux loss)."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.top_k
    c = capacity if capacity is not None else expert_capacity(n, cfg)
    tokens = x.reshape(n, d)

    probs, top_e, weights = _route(params["router"], tokens, k)

    # ---- dispatch ---------------------------------------------------------
    flat_e = top_e.reshape(n * k)
    rank = _rank_within_expert(flat_e, e)                     # (N·k,)
    keep = rank < c
    tok_rep = tokens.to(compute_dtype).repeat_interleave(k, dim=0)
    # a dropped copy goes to its expert's slot 0 as zeros
    slot = flat_e * c + torch.where(keep, rank, 0)
    contrib = torch.where(keep[:, None], tok_rep, 0.0)
    buf = torch.zeros((e * c, d), dtype=compute_dtype,
                      device=x.device).index_add(0, slot, contrib)

    # ---- the experts (batched over E; swiglu) ------------------------------
    # each weight cast where it is used, so that under inference one cast
    # expert tensor is alive at a time (DeepSeek-V3's is 15 GB in f32)
    buf = buf.view(e, c, d)
    h = F.silu(torch.bmm(buf, params["wg"]["w"].to(compute_dtype)))
    h = h * torch.bmm(buf, params["wi"]["w"].to(compute_dtype))
    expert_out = torch.bmm(h, params["wo"]["w"].to(compute_dtype)).view(
        e * c, d)                                             # (E·C, d)

    # ---- combine ----------------------------------------------------------
    gathered = torch.where(keep[:, None],
                           expert_out.index_select(0, slot), 0.0)
    wflat = weights.reshape(n * k, 1).to(compute_dtype)
    out = (gathered * wflat).reshape(n, k, d).sum(dim=1).reshape(b, s, d)

    # ---- shared experts ---------------------------------------------------
    if "shared" in params:
        out = out + layers.mlp(params["shared"], x, "swiglu",
                               compute_dtype=compute_dtype)

    # ---- load-balance aux loss (switch-style) -----------------------------
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, flat_e, torch.ones(n * k, dtype=torch.float32,
                              device=x.device)) / (n * k)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out.to(x.dtype), aux
