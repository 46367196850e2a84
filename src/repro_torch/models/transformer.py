"""The dense decoder stack (repro/models/transformer.py, dense case).

Layers keep the reference's parameter layout: a stack of identical dense
blocks is stored as one group ``stack/scan/sub_0`` whose leaves carry a
leading layer axis (the reference scans over it); a stack too short to
repeat (one layer) is unrolled as ``stack/suf_0``.  The forward walks the
layer axis in a Python loop over ``torch.unbind`` views, whose backward
stacks the per-layer gradients into one tensor per leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

__all__ = ["LayerPlan", "plan_layers", "init_model", "forward"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: int      # leading layers, unrolled
    period: int      # repeating-unit length
    n_groups: int    # scanned repetitions
    suffix: int      # trailing layers, unrolled


def plan_layers(num_layers: int) -> LayerPlan:
    """(prefix, period, n_groups, suffix) of the reference's plan_layers
    for a stack whose layers are all of one kind: every layer in one
    scanned group once the stack repeats (n >= 2), else unrolled."""
    n = num_layers
    best, best_score = LayerPlan(0, 1, 0, n), (n, 99)
    for prefix in range(0, min(4, n)):
        for period in range(1, 9):
            if n - prefix < 2 * period:
                continue
            groups = (n - prefix) // period
            plan = LayerPlan(prefix, period, groups,
                             n - prefix - period * groups)
            score = (plan.prefix + plan.suffix, period)
            if score < best_score:
                best, best_score = plan, score
    return best


def init_block(draws, cfg: ArchConfig) -> dict:
    d, dtype = cfg.d_model, cfg.param_dtype
    return {
        "norm1": layers.init_rms_norm(d, dtype, draws.device),
        "attn": attn_lib.init_attention(draws, d, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim,
                                        dtype),
        "norm2": layers.init_rms_norm(d, dtype, draws.device),
        "mlp": layers.init_mlp(draws, d, cfg.d_ff, dtype),
    }


def apply_block(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    h = layers.rms_norm(params["norm1"], x, cfg.norm_eps)
    x = x + attn_lib.attention(params["attn"], h, positions,
                               head_dim=cfg.head_dim,
                               rope_theta=cfg.rope_theta,
                               compute_dtype=cfg.compute_dtype)
    h2 = layers.rms_norm(params["norm2"], x, cfg.norm_eps)
    return x + layers.mlp(params["mlp"], h2, compute_dtype=cfg.compute_dtype)


def _stack_trees(trees: list) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _unbind_tree(tree, n: int) -> list:
    """Stacked dict → n per-layer dicts of views (one unbind per leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unbind_tree(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _init_stack(draws, cfg: ArchConfig) -> dict:
    plan = plan_layers(cfg.num_layers)
    params: dict = {}
    for i in range(plan.prefix):
        params[f"pre_{i}"] = init_block(draws, cfg)
    if plan.n_groups:
        params["scan"] = {
            f"sub_{j}": _stack_trees([init_block(draws, cfg)
                                      for _ in range(plan.n_groups)])
            for j in range(plan.period)}
    for i in range(plan.suffix):
        params[f"suf_{i}"] = init_block(draws, cfg)
    return params


def _apply_stack(params: dict, x, positions, cfg: ArchConfig):
    plan = plan_layers(cfg.num_layers)
    for i in range(plan.prefix):
        x = apply_block(params[f"pre_{i}"], x, positions, cfg)
    if plan.n_groups:
        groups = {j: _unbind_tree(params["scan"][f"sub_{j}"], plan.n_groups)
                  for j in range(plan.period)}
        for gi in range(plan.n_groups):
            for j in range(plan.period):
                x = apply_block(groups[j][gi], x, positions, cfg)
    for i in range(plan.suffix):
        x = apply_block(params[f"suf_{i}"], x, positions, cfg)
    return x


def init_model(draws, cfg: ArchConfig) -> dict:
    """Random initial weights on ``draws.device``, the reference's tree."""
    return {
        "embed": layers.init_embedding(draws, cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype),
        "stack": _init_stack(draws, cfg),
        "final_norm": layers.init_rms_norm(cfg.d_model, cfg.param_dtype,
                                           draws.device),
        "head": layers.init_dense(draws, (cfg.d_model, cfg.vocab_size),
                                  cfg.param_dtype),
    }


def forward(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Logits (B, S, V) for batch {'tokens' (B, S), 'positions' (B, S)}."""
    x = layers.embed(params["embed"], batch["tokens"],
                     compute_dtype=cfg.compute_dtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                         device=x.device)
    x = _apply_stack(params["stack"], x, batch["positions"], cfg)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return layers.unembed(params["head"], x, compute_dtype=cfg.compute_dtype)
