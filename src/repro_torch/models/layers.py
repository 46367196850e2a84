"""Building blocks of the port's language model (repro/models/layers.py).

Parameters are nested dicts of tensors in the reference's layout: dense
weights (in, out); q/k/v projections (d, heads, head_dim); the output
projection (heads, head_dim, d).  Normalisation math runs in f32.

Under a model group (``tp``, a sharding.tp.ModelGroup of M > 1 ranks)
the dense layer is column-parallel (the replicated input enters through
``tp.copy_to``, each rank computes its block of the outputs) or
row-parallel (each rank contracts its block of the inputs and
``tp.reduce_from`` sums the partial outputs); the MLP is both, wi/wg by
columns and wo by rows (Megatron); the embedding is vocabulary-parallel
(a rank's table holds a block of the rows: the tokens outside it read 0
and ``tp.reduce_from`` sums the lookups); the unembedding gives this
rank's block of the logits.  Where M does not divide the vocabulary,
the table and the head are blocks of d instead: the lookup's columns are
gathered, and the head sums the partial logits of its rows.  Norms stay
replicated, but for a norm over a partitioned width (Mamba2's gated
norm), whose sum of squares is all-reduced.  Which layer is
partitioned follows from its weights' blocks against the global dims
the caller passes (a d_ff or vocabulary that M does not divide stays
replicated, as ``sharding.param_pspecs`` leaves it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import tp as tp_lib

__all__ = ["init_rms_norm", "rms_norm", "init_layer_norm", "layer_norm",
           "init_dense", "dense", "gelu", "init_mlp", "mlp", "init_embedding",
           "embed", "unembed", "rope_frequencies", "apply_rope",
           "mrope_sections", "apply_mrope"]


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6, *,
             tp=None, width: int | None = None):
    """x / rms(x) · (1 + scale), in f32 (the reference's 1+scale form).

    With a model group ``tp``, x is this rank's block of the ``width``
    features (the replicated scale is cut to it): the f32 sum of squares
    is taken over the block and all-reduced in both directions
    (``reduce_from`` then ``copy_to``: every rank's gradient of the sum
    is partial), then divided by ``width``."""
    dtype = x.dtype
    x32 = x.float()
    scale = params["scale"]
    if tp is None:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    else:
        sq = torch.sum(x32 * x32, dim=-1, keepdim=True)
        var = tp_lib.copy_to(tp_lib.reduce_from(sq, tp), tp) / width
        scale = tp_lib.weight_for(scale, (width,), tp, 0)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


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


def dense(params: dict, x: torch.Tensor, compute_dtype=None, *,
          tp=None, parallel: str | None = None) -> torch.Tensor:
    """x @ w (+ b) contracting x's last dim with w's first (w may be
    (d, H, hd)).  Without ``compute_dtype`` the operands are promoted to
    a common dtype, as the reference's mixed-dtype dot_general does.

    With a model group ``tp``: ``parallel='column'`` takes the replicated
    x through ``copy_to`` and gives this rank's block of the outputs (w
    and b its column blocks); ``parallel='row'`` contracts this rank's
    block of x's last dim with its block of w's rows and sums the
    partials with ``reduce_from``, the bias (replicated) added after."""
    w = params["w"]
    dtype = compute_dtype if compute_dtype is not None else \
        torch.promote_types(x.dtype, w.dtype)
    if tp is not None and parallel == "column":
        x = tp_lib.copy_to(x, tp)
    y = torch.tensordot(x.to(dtype), w.to(dtype), dims=1)
    if tp is not None and parallel == "row":
        y = tp_lib.reduce_from(y, tp)
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
        compute_dtype=None, *, tp=None, d_ff: int | None = None
        ) -> torch.Tensor:
    """SwiGLU (silu(x wg) * x wi) wo or GeGLU with gelu for silu;
    squared-ReLU relu(x wi)² wo or GELU gelu(x wi) wo.  With a model
    group ``tp`` and wi holding a block of the global ``d_ff`` columns:
    wi and wg column-parallel (x enters through one ``copy_to``), the
    activation on the block, wo row-parallel."""
    if kind not in _GATES and kind not in _ACTS:
        raise ValueError(f"unknown mlp kind {kind!r}")
    if tp is not None and params["wi"]["w"].shape[-1] != d_ff:
        x = tp_lib.copy_to(x, tp)
    else:
        tp = None
    h = dense(params["wi"], x, compute_dtype=compute_dtype)
    if kind in _GATES:
        h = _GATES[kind](dense(params["wg"], x,
                               compute_dtype=compute_dtype)) * h
    else:
        h = _ACTS[kind](h)
    return dense(params["wo"], h, compute_dtype=compute_dtype, tp=tp,
                 parallel="row")


def init_embedding(draws, vocab: int, d: int, dtype) -> dict:
    return {"table": draws.normal((vocab, d)).mul_(0.02).to(dtype)}


def _table_layout(shape: tuple, vocab: int | None, d: int | None, tp,
                  what: str) -> str | None:
    """How a (vocab, d) table's or a (d, vocab) head's block is cut
    (``shape`` in the table's order): None whole (or no model group),
    'vocab' a block of the vocabulary's rows, 'd' a block of d (where M
    does not divide the vocabulary, ``param_pspecs``' fallback); without
    ``d`` the block is whole along d."""
    d = shape[1] if d is None else d
    if tp is None or tuple(shape) == (vocab, d):
        return None
    if shape[0] * tp.size == vocab and shape[1] == d:
        return "vocab"
    if shape[0] == vocab and shape[1] * tp.size == d:
        return "d"
    raise ValueError(f"{what}: a block {tuple(shape)} of a ({vocab}, {d}) "
                     f"table over {tp.size} model ranks")


def embed(params: dict, tokens: torch.Tensor, compute_dtype=None, *,
          tp=None, vocab: int | None = None, d: int | None = None):
    """The rows of ``tokens``; with a model group ``tp`` and a table
    block of the (``vocab``, ``d``) table: a block of the vocabulary's
    rows is vocabulary-parallel (a token outside this rank's rows reads
    0, and ``reduce_from`` sums the lookups); a block of d looks up this
    rank's columns and ``gather_whole`` puts them together (the gradient
    downstream is whole on every rank, and this rank's block of it is
    taken back)."""
    tbl = params["table"]
    if compute_dtype is not None:
        tbl = tbl.to(compute_dtype)
    layout = _table_layout(tbl.shape, vocab, d, tp, "embed")
    if layout is None:
        return F.embedding(tokens, tbl)
    if layout == "d":
        return tp_lib.gather_whole(F.embedding(tokens, tbl), tp, -1)
    rows = tbl.shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), tbl) * \
        mine[..., None].to(tbl.dtype)
    return tp_lib.reduce_from(out, tp)


def unembed(params: dict, x: torch.Tensor, compute_dtype=None, *,
            tp=None, vocab: int | None = None):
    """Logits via the untied output head; params = {'w': (d, vocab)}.
    With a model group ``tp``: a head block of the ``vocab`` columns is
    column-parallel, giving this rank's block of the logits; a block of
    d's rows contracts this rank's block of x (``copy_to`` first: x's
    gradient is then summed whole) and ``reduce_from`` sums the partial
    logits, whole on every rank."""
    w = params["w"]
    d = x.shape[-1]
    layout = _table_layout(w.shape[::-1], vocab, d, tp, "unembed")
    if layout == "d":
        rows = w.shape[0]
        x = tp_lib.copy_to(x, tp).narrow(-1, tp.rank * rows, rows)
        return dense(params, x, compute_dtype=compute_dtype, tp=tp,
                     parallel="row")
    return dense(params, x, compute_dtype=compute_dtype,
                 tp=tp if layout else None, parallel="column")


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim (f32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) with its halves (x1, x2) rotated by angles
    (..., S, hd/2), in f32."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """RoPE on (..., S, H, hd) with (..., S) positions: the head dim is
    split in halves (x1, x2) rotated by position · inv_freq, in f32."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    return _rotate(x, positions.float()[..., None] * inv)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """The reference's (temporal, height, width) split of the half head
    dim: (half − 2·(half // 4), half // 4, half // 4)."""
    half = head_dim // 2
    return (half - 2 * (half // 4), half // 4, half // 4)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float = 10_000.0,
                sections: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191 §2.1) on x (..., S, H,
    hd): the half head dim's frequency bands are split into (temporal,
    height, width) sections, each rotated by its own component of the
    (3, ..., S) positions (in f32).  With three equal components it is
    :func:`apply_rope` exactly.  The band of each frequency is picked by
    a tensor index, so it batches under ``torch.func.vmap``."""
    half = x.shape[-1] // 2
    if sections is None:
        sections = mrope_sections(x.shape[-1])
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to the "
                         f"half head dim {half}")
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)
    idx = torch.arange(half, device=x.device)
    band = (idx >= sections[0]).long() + \
        (idx >= sections[0] + sections[1]).long()           # (half,)
    pos = positions_3d.float().index_select(0, band)        # (half, ..., S)
    return _rotate(x, pos.movedim(0, -1) * inv)
