"""The decoder stack (repro/models/transformer.py): attention, Mamba2 SSM
and Griffin RG-LRU blocks, chosen per layer by ``cfg.block_kind``.

Layers keep the reference's parameter layout: ``plan_layers`` splits the
stack into unrolled ``pre_i`` layers, a repeating unit of ``period``
layers stored once as ``scan/sub_j`` whose leaves carry a leading group
axis (the reference scans over it), and unrolled ``suf_i`` layers, so any
reference model's weights carry across unchanged.  The forward walks the
group axis in a Python loop over ``torch.unbind`` views, whose backward
stacks the per-layer gradients into one tensor per leaf.  ``impl`` picks
each block's prefill path: 'xla' (plain PyTorch) or 'pallas' (the CUDA
kernels #15–#17; forward only).

Decode caches mirror the same prefix/group/suffix structure
(:func:`init_decode_caches`): a scanned group's cache leaves, its
``positions`` and ``index`` too, carry the leading group axis, so the
reference's cache trees carry across leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import griffin, layers
from repro_torch.models import ssm as ssm_lib
from repro_torch.tree import tree_map

__all__ = ["LayerPlan", "plan_layers", "init_model", "forward",
           "init_decode_caches"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: int      # leading layers, unrolled
    period: int      # repeating-unit length
    n_groups: int    # scanned repetitions
    suffix: int      # trailing layers, unrolled


def _kind_key(cfg: ArchConfig, i: int) -> tuple:
    return cfg.block_kind(i), cfg.is_local_layer(i)


def plan_layers(cfg: ArchConfig) -> LayerPlan:
    """(prefix, period, n_groups, suffix) minimising (unrolled layers,
    period), as the reference chooses it: e.g. recurrentgemma's 38 layers
    → period 3 × 12 groups + a suffix of 2."""
    n = cfg.num_layers
    kinds = [_kind_key(cfg, i) for i in range(n)]
    best, best_score = LayerPlan(0, 1, 0, n), (n, 99)
    for prefix in range(0, min(4, n)):
        for period in range(1, 9):
            if n - prefix < 2 * period:
                continue
            unit = kinds[prefix: prefix + period]
            i, groups = prefix, 0
            while i + period <= n and kinds[i: i + period] == unit:
                groups += 1
                i += period
            if groups < 2:
                continue
            plan = LayerPlan(prefix, period, groups, n - i)
            score = (plan.prefix + plan.suffix, period)
            if score < best_score:
                best, best_score = plan, score
    return best


def init_block(draws, cfg: ArchConfig, layer_idx: int) -> dict:
    d, dtype = cfg.d_model, cfg.param_dtype
    kind = cfg.block_kind(layer_idx)
    p = {"norm1": layers.init_rms_norm(d, dtype, draws.device)}
    if kind == "attn":
        p["attn"] = attn_lib.init_attention(draws, d, cfg.num_heads,
                                            cfg.num_kv_heads, cfg.head_dim,
                                            dtype, bias=cfg.qkv_bias)
    elif kind == "ssm":
        p["mixer"] = ssm_lib.init_mamba2(draws, d, cfg.ssm, dtype)
        return p  # pure mamba stack: no MLP half
    elif kind == "rglru":
        p["mixer"] = griffin.init_rglru_block(draws, d, cfg.d_ff_rglru,
                                              dtype)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["norm2"] = layers.init_rms_norm(d, dtype, draws.device)
    p["mlp"] = layers.init_mlp(draws, d, cfg.d_ff, dtype)
    return p


def _layer_window(cfg: ArchConfig, layer_idx: int,
                  long_variant: bool = False) -> int:
    """The layer's attention window (0 ⇒ full causal); ``long_variant``
    gives full-attention layers the config's long-context window."""
    if cfg.sliding_window > 0 and cfg.is_local_layer(layer_idx):
        return cfg.sliding_window
    if long_variant and cfg.long_context_window > 0:
        return cfg.long_context_window
    return 0


def apply_block(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, layer_idx: int, impl: str = "xla", *,
                cache: dict | None = None, long_variant: bool = False):
    """One block; returns (x, its new cache or None)."""
    kind = cfg.block_kind(layer_idx)
    cdt = cfg.compute_dtype
    h = layers.rms_norm(params["norm1"], x, cfg.norm_eps)
    self_cache = None if cache is None else cache["self"]
    if kind == "attn":
        y, c = attn_lib.attention(
            params["attn"], h, positions, head_dim=cfg.head_dim,
            window=_layer_window(cfg, layer_idx, long_variant),
            rope_kind=cfg.rope_kind, rope_theta=cfg.rope_theta,
            cache=self_cache, compute_dtype=cdt, impl=impl)
    elif kind == "ssm":
        y, c = ssm_lib.mamba2_block(params["mixer"], h, cfg.ssm,
                                    compute_dtype=cdt, cache=self_cache,
                                    use_pallas=impl == "pallas")
        return x + y, None if c is None else {"self": c}
    else:
        y, c = griffin.rglru_block(params["mixer"], h, compute_dtype=cdt,
                                   cache=self_cache,
                                   use_pallas=impl == "pallas")
    x = x + y
    h2 = layers.rms_norm(params["norm2"], x, cfg.norm_eps)
    return x + layers.mlp(params["mlp"], h2, cfg.mlp_kind,
                          compute_dtype=cdt), \
        None if c is None else {"self": c}


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
    plan = plan_layers(cfg)
    params: dict = {}
    for i in range(plan.prefix):
        params[f"pre_{i}"] = init_block(draws, cfg, i)
    if plan.n_groups:
        params["scan"] = {
            f"sub_{j}": _stack_trees([init_block(draws, cfg, plan.prefix + j)
                                      for _ in range(plan.n_groups)])
            for j in range(plan.period)}
    for i in range(plan.suffix):
        li = plan.prefix + plan.period * plan.n_groups + i
        params[f"suf_{i}"] = init_block(draws, cfg, li)
    return params


def _apply_stack(params: dict, x, positions, cfg: ArchConfig,
                 impl: str = "xla", caches: dict | None = None,
                 long_variant: bool = False):
    """(x, the new caches or None) through every layer; the j-th layer of
    the repeating unit stands for its kind (index ``prefix + j``)."""
    plan = plan_layers(cfg)
    decode = caches is not None
    kw = dict(long_variant=long_variant)
    new: dict = {}
    for i in range(plan.prefix):
        key = f"pre_{i}"
        x, new[key] = apply_block(params[key], x, positions, cfg, i, impl,
                                  cache=caches[key] if decode else None, **kw)
    if plan.n_groups:
        def per_group(tree, j):
            return _unbind_tree(tree["scan"][f"sub_{j}"], plan.n_groups)

        groups = [per_group(params, j) for j in range(plan.period)]
        gcaches = [per_group(caches, j) if decode else
                   [None] * plan.n_groups for j in range(plan.period)]
        gnew = [[] for _ in range(plan.period)]
        for gi in range(plan.n_groups):
            for j in range(plan.period):
                x, c = apply_block(groups[j][gi], x, positions, cfg,
                                   plan.prefix + j, impl,
                                   cache=gcaches[j][gi], **kw)
                gnew[j].append(c)
        if decode:
            new["scan"] = {f"sub_{j}": _stack_trees(gnew[j])
                           for j in range(plan.period)}
    for i in range(plan.suffix):
        key, li = f"suf_{i}", plan.prefix + plan.period * plan.n_groups + i
        x, new[key] = apply_block(params[key], x, positions, cfg, li, impl,
                                  cache=caches[key] if decode else None, **kw)
    return x, new if decode else None


def init_model(draws, cfg: ArchConfig) -> dict:
    """Random initial weights on ``draws.device``, the reference's tree."""
    params = {
        "embed": layers.init_embedding(draws, cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype),
        "stack": _init_stack(draws, cfg),
        "final_norm": layers.init_rms_norm(cfg.d_model, cfg.param_dtype,
                                           draws.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.init_dense(
            draws, (cfg.d_model, cfg.vocab_size), cfg.param_dtype)
    return params


def forward(params: dict, batch: dict, cfg: ArchConfig,
            impl: str = "xla", *, caches: dict | None = None,
            long_variant: bool = False):
    """Logits (B, S, V) for batch {'tokens' (B, S), 'positions' (B, S)};
    with ``caches`` (decode, S = 1) the pair (logits, new caches)."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    x = layers.embed(params["embed"], batch["tokens"],
                     compute_dtype=cfg.compute_dtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                         device=x.device)
    x, new_caches = _apply_stack(params["stack"], x, batch["positions"], cfg,
                                 impl, caches, long_variant)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x,
                              params["embed"]["table"].to(x.dtype))
    else:
        logits = layers.unembed(params["head"], x,
                                compute_dtype=cfg.compute_dtype)
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits if caches is None else (logits, new_caches)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _block_cache(cfg: ArchConfig, layer_idx: int, batch: int, cache_len: int,
                 long_variant: bool, dtype, device) -> dict:
    kind = cfg.block_kind(layer_idx)
    if kind == "ssm":
        return {"self": ssm_lib.init_mamba2_cache(batch, cfg.d_model,
                                                  cfg.ssm, device=device)}
    if kind == "rglru":
        return {"self": griffin.init_rglru_cache(batch, cfg.d_ff_rglru,
                                                 device=device)}
    window = _layer_window(cfg, layer_idx, long_variant)
    eff_len = min(cache_len, window) if window > 0 else cache_len
    return {"self": attn_lib.init_cache(batch, eff_len, cfg.num_kv_heads,
                                        cfg.head_dim, dtype, device=device)}


def init_decode_caches(cfg: ArchConfig, batch: int, cache_len: int, *,
                       long_variant: bool = False, dtype=torch.bfloat16,
                       device) -> dict:
    """The cache tree mirroring the stack's prefix/scan/suffix; an
    attention layer's cache holds ``cache_len`` slots, or its window's if
    that is shorter (a ring buffer)."""
    plan = plan_layers(cfg)

    def cache(li):
        return _block_cache(cfg, li, batch, cache_len, long_variant, dtype,
                            device)

    caches: dict = {f"pre_{i}": cache(i) for i in range(plan.prefix)}
    if plan.n_groups:
        caches["scan"] = {f"sub_{j}": tree_map(
            lambda leaf: leaf.expand((plan.n_groups,) + leaf.shape).clone(),
            cache(plan.prefix + j)) for j in range(plan.period)}
    for i in range(plan.suffix):
        li = plan.prefix + plan.period * plan.n_groups + i
        caches[f"suf_{i}"] = cache(li)
    return caches
