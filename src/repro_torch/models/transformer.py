"""The layer stack (repro/models/transformer.py): attention (GQA or
MLA), Mamba2 SSM and Griffin RG-LRU blocks, chosen per layer by
``cfg.block_kind``, each attention or RG-LRU block's MLP half a dense MLP
or, past an MoE config's leading dense layers, an MoE whose load-balance
loss the stack sums (``forward`` returns it beside the logits).

An encoder-decoder config (SeamlessM4T) has a second stack of
``encoder_layers`` (``enc_stack``, ``enc_norm``) run without a causal
mask over the batch's stub frame embeddings (``enc_embeds``), and each
decoder block a cross-attention (``cross_norm``, ``cross_attn``) to the
encoder memory.  A vision config (Qwen2-VL) takes its stub patch
embeddings (``frontend_embeds``) in place of its first positions' token
embeddings, and an M-RoPE config the batch's ``mrope_positions``.

Layers keep the reference's parameter layout: ``plan_layers`` splits the
stack into unrolled ``pre_i`` layers, a repeating unit of ``period``
layers stored once as ``scan/sub_j`` whose leaves carry a leading group
axis (the reference scans over it), and unrolled ``suf_i`` layers, so any
reference model's weights carry across unchanged.  The forward walks the
group axis in a Python loop over ``torch.unbind`` views, whose backward
stacks the per-layer gradients into one tensor per leaf; with ``remat``
(the default) each group is one rematerialised unit (models/remat.py),
as the reference checkpoints its scan body.  At init each
stacked leaf is allocated once with its group axis and filled group by
group, so that init costs the weights' bytes plus one block.  ``impl``
picks each block's prefill path: 'xla' (plain PyTorch) or 'pallas' (the
CUDA kernels #15–#17; forward only; MLA and MoE layers have no kernel and
run the plain path under either).

Decode caches mirror the same prefix/group/suffix structure
(:func:`init_decode_caches`): a scanned group's cache leaves, its
``positions`` and ``index`` too, carry the leading group axis, so the
reference's cache trees carry across leaf for leaf.

Under a config's ``tp_axis_name`` with an ambient model group of M > 1
ranks (sharding/tp.py; the engines make it ambient around line 4) the
forward is tensor-parallel on the rank's parameter blocks: the
vocabulary-parallel embedding, each block's attention and MLP over the
group (models/attention.py, mla.py, moe.py, layers.py), the norms and
the residual stream replicated, and the logits this rank's block of the
vocabulary (a tied table's block serves both of its uses, so its
gradient collects both), or, where M does not divide the vocabulary, a
table and head cut on d and whole logits (models/layers.py).  Mamba2's
blocks run on the rank's heads (models/ssm.py) and RG-LRU blocks on its
block of the width (models/griffin.py).  An encoder-decoder's encoder
stack runs on the rank's blocks too, its memory replicated, and each
decoder block's cross-attention on the rank's heads reads it whole
(models/attention.py); a vision config's stub patch embeddings, batch
data like the M-RoPE ids, take the first positions of the replicated
embedding.  Every family of the ``sharded`` agent layout is ported
(``tp.check_family``), and only without decode caches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import griffin, layers
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import remat as remat_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding import tp as tp_lib
from repro_torch.tree import leaves, tree_map

__all__ = ["LayerPlan", "plan_layers", "init_model", "forward",
           "init_decode_caches"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: int      # leading layers, unrolled
    period: int      # repeating-unit length
    n_groups: int    # scanned repetitions
    suffix: int      # trailing layers, unrolled


def _kind_key(cfg: ArchConfig, i: int) -> tuple:
    moe_layer = cfg.moe is not None and i >= cfg.moe.first_dense_layers
    return (cfg.block_kind(i), cfg.is_local_layer(i), moe_layer,
            cfg._layer_d_ff(i))


def plan_layers(cfg: ArchConfig, num_layers: int | None = None
                ) -> LayerPlan:
    """(prefix, period, n_groups, suffix) of a stack of ``num_layers``
    (default: the decoder's ``cfg.num_layers``) minimising (unrolled
    layers, period), as the reference chooses it: e.g. recurrentgemma's
    38 layers → period 3 × 12 groups + a suffix of 2, DeepSeek-V2-Lite's
    27 → a dense prefix of 1 + 26 MoE groups of 1."""
    n = cfg.num_layers if num_layers is None else num_layers
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


def init_block(draws, cfg: ArchConfig, layer_idx: int,
               cross: bool = False) -> dict:
    """One block's weights; ``cross`` adds a cross-attention (no bias)
    and its norm."""
    d, dtype = cfg.d_model, cfg.param_dtype
    kind = cfg.block_kind(layer_idx)
    p = {"norm1": layers.init_rms_norm(d, dtype, draws.device)}
    if kind == "attn" and cfg.attention_kind == "mla":
        p["attn"] = mla_lib.init_mla(draws, d, cfg.num_heads, cfg.mla, dtype)
    elif kind == "attn":
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
    if cross:
        p["cross_norm"] = layers.init_rms_norm(d, dtype, draws.device)
        p["cross_attn"] = attn_lib.init_attention(
            draws, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, dtype)
    p["norm2"] = layers.init_rms_norm(d, dtype, draws.device)
    if cfg.moe is not None and layer_idx >= cfg.moe.first_dense_layers:
        p["moe"] = moe_lib.init_moe(draws, d, cfg.moe, dtype)
    else:
        p["mlp"] = layers.init_mlp(draws, d, cfg._layer_d_ff(layer_idx),
                                   dtype, cfg.mlp_kind)
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
                cache: dict | None = None, long_variant: bool = False,
                mrope_positions=None, enc_out=None, causal: bool = True,
                tp=None):
    """One block; returns (x, its new cache or None, its MoE aux loss:
    0.0 without an MoE).  A block with a cross-attention attends
    ``enc_out`` after its self-attention; ``causal`` False is the
    encoder's unmasked self-attention.  ``tp``: the model group of a
    tensor-parallel forward (a GQA or MLA block with a dense MLP or an
    MoE, its cross-attention on the rank's heads, a Mamba2 block on the
    rank's heads, an RG-LRU block on its width)."""
    kind = cfg.block_kind(layer_idx)
    cdt = cfg.compute_dtype
    h = layers.rms_norm(params["norm1"], x, cfg.norm_eps)
    self_cache = None if cache is None else cache["self"]
    if kind == "attn" and cfg.attention_kind == "mla":
        y, c = mla_lib.mla_attention(
            params["attn"], h, positions, cfg=cfg.mla,
            rope_theta=cfg.rope_theta,
            window=_layer_window(cfg, layer_idx, long_variant),
            cache=self_cache, compute_dtype=cdt, tp=tp,
            num_heads=cfg.num_heads)
    elif kind == "attn":
        y, c = attn_lib.attention(
            params["attn"], h, positions, head_dim=cfg.head_dim,
            window=_layer_window(cfg, layer_idx, long_variant),
            rope_kind=cfg.rope_kind, rope_theta=cfg.rope_theta,
            mrope_positions=mrope_positions, cache=self_cache,
            causal=causal, compute_dtype=cdt, impl=impl, tp=tp,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            weight_gather=cfg.attn_weight_gather,
            chunked_prefill=cfg.attn_chunked_prefill)
    elif kind == "ssm":
        y, c = ssm_lib.mamba2_block(params["mixer"], h, cfg.ssm,
                                    compute_dtype=cdt, cache=self_cache,
                                    use_pallas=impl == "pallas", tp=tp)
        return x + y, None if c is None else {"self": c}, 0.0
    else:
        y, c = griffin.rglru_block(params["mixer"], h, compute_dtype=cdt,
                                   cache=self_cache,
                                   use_pallas=impl == "pallas", tp=tp,
                                   width=cfg.d_ff_rglru)
    x = x + y
    if "cross_attn" in params:
        if enc_out is None:
            raise ValueError("a cross-attention block needs enc_out")
        hc = layers.rms_norm(params["cross_norm"], x, cfg.norm_eps)
        y, _ = attn_lib.attention(
            params["cross_attn"], hc, positions, head_dim=cfg.head_dim,
            rope_kind="none", kv_override=enc_out, causal=False,
            compute_dtype=cdt, tp=tp, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            chunked_prefill=cfg.attn_chunked_prefill)
        x = x + y
    h2 = layers.rms_norm(params["norm2"], x, cfg.norm_eps)
    aux = 0.0
    if "moe" in params:
        y, aux = moe_lib.moe_layer(params["moe"], h2, cfg.moe,
                                   compute_dtype=cdt, tp=tp)
    else:
        y = layers.mlp(params["mlp"], h2, cfg.mlp_kind, compute_dtype=cdt,
                       tp=tp, d_ff=cfg._layer_d_ff(layer_idx))
    return x + y, None if c is None else {"self": c}, aux


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


def _init_group(draws, cfg: ArchConfig, layer_idx: int, n_groups: int,
                cross: bool = False) -> dict:
    """n_groups blocks of the unit's layer ``layer_idx``, drawn one after
    another, stacked: each leaf allocated once with its group axis on the
    first block and filled group by group, every block dropped once it
    is copied in, so the peak is the stack's bytes plus one block.  One
    group is its block's leaves viewed with a group axis, not copied, so
    the peak is the weights plus the largest leaf's f32 draw (a bf16
    leaf is drawn in f32 and cast)."""
    if n_groups == 1:
        return tree_map(lambda leaf: leaf[None],
                        init_block(draws, cfg, layer_idx, cross))
    stacked = None
    for g in range(n_groups):
        block = init_block(draws, cfg, layer_idx, cross)
        if stacked is None:
            stacked = tree_map(
                lambda leaf: leaf.new_empty((n_groups,) + leaf.shape), block)
        for dst, src in zip(leaves(stacked), leaves(block)):
            dst[g].copy_(src)
        del block
    return stacked


def _init_stack(draws, cfg: ArchConfig, num_layers: int | None = None,
                cross: bool = False) -> dict:
    """A stack of ``num_layers`` blocks (default: the decoder's), with
    cross-attention where ``cross``."""
    plan = plan_layers(cfg, num_layers)
    params: dict = {}
    for i in range(plan.prefix):
        params[f"pre_{i}"] = init_block(draws, cfg, i, cross)
    if plan.n_groups:
        params["scan"] = {
            f"sub_{j}": _init_group(draws, cfg, plan.prefix + j,
                                    plan.n_groups, cross)
            for j in range(plan.period)}
    for i in range(plan.suffix):
        li = plan.prefix + plan.period * plan.n_groups + i
        params[f"suf_{i}"] = init_block(draws, cfg, li, cross)
    return params


def _apply_stack(params: dict, x, positions, cfg: ArchConfig,
                 impl: str = "xla", caches: dict | None = None,
                 long_variant: bool = False, *,
                 num_layers: int | None = None, mrope_positions=None,
                 enc_out=None, causal: bool = True, tp=None,
                 remat: bool = True):
    """(x, the new caches or None, the summed MoE aux loss) through every
    layer of a stack of ``num_layers`` (default: the decoder's); the j-th
    layer of the repeating unit stands for its kind (index
    ``prefix + j``).  With ``remat`` (and no caches) each scanned group,
    its ``period`` blocks together, is one rematerialised unit
    (models/remat.py), as the reference checkpoints its scan body; the
    prefix and suffix layers keep their activations.  A group's aux
    losses are summed before they join the total, with or without
    ``remat``, so that both give the same numbers."""
    plan = plan_layers(cfg, num_layers)
    decode = caches is not None
    kw = dict(long_variant=long_variant, mrope_positions=mrope_positions,
              enc_out=enc_out, causal=causal, tp=tp)
    new: dict = {}
    aux_total = 0.0
    for i in range(plan.prefix):
        key = f"pre_{i}"
        x, new[key], aux = apply_block(params[key], x, positions, cfg, i,
                                       impl, cache=caches[key] if decode
                                       else None, **kw)
        aux_total = aux_total + aux
    if plan.n_groups:
        def per_group(tree, j):
            return _unbind_tree(tree["scan"][f"sub_{j}"], plan.n_groups)

        groups = [per_group(params, j) for j in range(plan.period)]
        if decode:
            gcaches = [per_group(caches, j) for j in range(plan.period)]
            gnew = [[] for _ in range(plan.period)]
            for gi in range(plan.n_groups):
                for j in range(plan.period):
                    x, c, aux = apply_block(groups[j][gi], x, positions,
                                            cfg, plan.prefix + j, impl,
                                            cache=gcaches[j][gi], **kw)
                    aux_total = aux_total + aux
                    gnew[j].append(c)
            new["scan"] = {f"sub_{j}": _stack_trees(gnew[j])
                           for j in range(plan.period)}
        else:
            def group(xx, gparams, pos, mrope, enc):
                gaux = 0.0
                for j in range(plan.period):
                    xx, _, aux = apply_block(
                        gparams[j], xx, pos, cfg, plan.prefix + j, impl,
                        long_variant=long_variant, mrope_positions=mrope,
                        enc_out=enc, causal=causal, tp=tp)
                    gaux = gaux + aux
                return (xx, gaux) if isinstance(gaux, torch.Tensor) \
                    else (xx,)

            for gi in range(plan.n_groups):
                args = (x, [groups[j][gi] for j in range(plan.period)],
                        positions, mrope_positions, enc_out)
                out = remat_lib.checkpoint(group, *args) if remat \
                    else group(*args)
                x = out[0]
                if len(out) > 1:
                    aux_total = aux_total + out[1]
    for i in range(plan.suffix):
        key, li = f"suf_{i}", plan.prefix + plan.period * plan.n_groups + i
        x, new[key], aux = apply_block(params[key], x, positions, cfg, li,
                                       impl, cache=caches[key] if decode
                                       else None, **kw)
        aux_total = aux_total + aux
    return x, new if decode else None, aux_total


def init_model(draws, cfg: ArchConfig) -> dict:
    """Random initial weights on ``draws.device``, the reference's tree."""
    params = {
        "embed": layers.init_embedding(draws, cfg.vocab_size, cfg.d_model,
                                       cfg.param_dtype),
        "stack": _init_stack(draws, cfg, cross=cfg.is_encoder_decoder),
        "final_norm": layers.init_rms_norm(cfg.d_model, cfg.param_dtype,
                                           draws.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.init_dense(
            draws, (cfg.d_model, cfg.vocab_size), cfg.param_dtype)
    if cfg.is_encoder_decoder:
        params["enc_stack"] = _init_stack(draws, cfg, cfg.encoder_layers)
        params["enc_norm"] = layers.init_rms_norm(
            cfg.d_model, cfg.param_dtype, draws.device)
    return params


def _embed_inputs(params: dict, cfg: ArchConfig, batch: dict, tp=None):
    """Token embeddings scaled by √d (vocabulary-parallel under a model
    group ``tp``); a vision config's batch ``frontend_embeds`` (B, P, d)
    then take the first P positions, unscaled (the reference's order).
    Under ``tp`` the embedding is replicated and the patch embeddings are
    the same batch data on every rank of the group, so the result is
    replicated too."""
    x = layers.embed(params["embed"], batch["tokens"],
                     compute_dtype=cfg.compute_dtype, tp=tp,
                     vocab=cfg.vocab_size, d=cfg.d_model)
    # a factory, not torch.tensor: under a grad transform and a dispatch
    # mode (launch/trace_analysis.py) torch.tensor's detach_ is refused
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=cfg.compute_dtype,
                       device=x.device)
    if cfg.frontend == "vision" and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(cfg.compute_dtype)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return x


def _encode(params: dict, cfg: ArchConfig, batch: dict, impl: str = "xla",
            tp=None):
    """The encoder memory (B, T, d): the batch's stub frame embeddings
    ``enc_embeds`` (B, T, d) through the encoder stack, unmasked, at
    positions 0 .. T-1, then ``enc_norm``.  Its self-attention is not
    causal, so it reaches no kernel under either impl.  Under a model
    group ``tp`` the stack runs on the rank's blocks and the memory
    comes out replicated (``enc_norm`` is).  Its groups are always
    rematerialised, as the reference's ``_encode`` leaves its default
    on."""
    enc_x = batch["enc_embeds"].to(cfg.compute_dtype)
    pos = torch.arange(enc_x.shape[1], device=enc_x.device).expand(
        enc_x.shape[:2])
    enc_x, _, _ = _apply_stack(params["enc_stack"], enc_x, pos, cfg, impl,
                               num_layers=cfg.encoder_layers, causal=False,
                               tp=tp)
    return layers.rms_norm(params["enc_norm"], enc_x, cfg.norm_eps)


def forward(params: dict, batch: dict, cfg: ArchConfig,
            impl: str = "xla", *, caches: dict | None = None,
            enc_out=None, long_variant: bool = False, remat: bool = True):
    """(logits (B, S, V), the MoE aux loss (0.0 without an MoE), the new
    caches or None) for batch {'tokens' (B, S), 'positions' (B, S)}, with
    'mrope_positions' (3, B, S) for an M-RoPE config, optional
    'frontend_embeds' (B, P, d) for a vision one, and 'enc_embeds' (B, T,
    d) for an encoder-decoder one unless ``enc_out`` (its encoder memory)
    is given; ``caches`` (decode, S = 1) gives the new ones.  ``remat``
    rematerialises each scanned group of the decoder in the backward (a
    decode step never does); the encoder's groups always are, as the
    reference's ``_encode`` leaves its default on."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    tp = tp_lib.active(cfg.tp_axis_name)
    if tp is not None:
        _check_tp(cfg, caches)
    if cfg.is_encoder_decoder and enc_out is None:
        enc_out = _encode(params, cfg, batch, impl, tp)
    x = _embed_inputs(params, cfg, batch, tp)
    x, new_caches, aux = _apply_stack(
        params["stack"], x, batch["positions"], cfg, impl, caches,
        long_variant, mrope_positions=batch.get("mrope_positions"),
        enc_out=enc_out, tp=tp, remat=remat)
    x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        if tp is not None and table.shape[-1] != cfg.d_model:
            raise NotImplementedError(
                f"{cfg.name}: a tied table cut on d (a vocabulary of "
                f"{cfg.vocab_size} that the model group does not divide) "
                f"is not ported")
        if tp is not None and table.shape[0] != cfg.vocab_size:
            x = tp_lib.copy_to(x, tp)
        logits = torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))
    else:
        logits = layers.unembed(params["head"], x,
                                compute_dtype=cfg.compute_dtype, tp=tp,
                                vocab=cfg.vocab_size)
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits, aux, new_caches


def _check_tp(cfg: ArchConfig, caches) -> None:
    """The tensor-parallel forward's limits: the ported families
    (``tp.check_family``) and no decode caches."""
    tp_lib.check_family(cfg)
    if caches is not None:
        raise NotImplementedError(
            "tensor-parallel decode (serve_param_pspecs/cache_pspecs) is "
            "not ported (ROADMAP.md Queue A item 6.5)")


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
    if cfg.attention_kind == "mla":
        return {"self": mla_lib.init_mla_cache(batch, eff_len, cfg.mla,
                                               dtype, device=device)}
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
