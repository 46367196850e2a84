"""Compressed gossip with error feedback (repro/core/compress.py, for the
flat (n, D) buffer, the (R, n, D) sweep lattice and the tree engine's
stacked dict).

The gossip payload is compressed while the local updates stay at full
precision, with a CHOCO-style error-feedback residual that carries the
compression error into the next exchange.  With ``p_i`` the post-update
iterate (Algorithm 1's x_i^{t+1/2}) and ``e_i`` the carried residual:

    u_i  = p_i + e_i                  # error-compensated payload
    s_i  = decode(encode(u_i))        # what the wire carries, dequantized
    e_i' = u_i − s_i                  # residual for the next step
    y_i  = Σ_j W_ij s_j + W_ii (p_i − s_i)

Every agent mixes its neighbours' compressed values and keeps its own
iterate at full precision.  With the identity codec s = u = p, the
residual stays 0 and y = W p: the uncompressed trajectory.
``gossip_compress='none'`` skips all of this (no residual state).

Codecs, per row of the (n, D) buffer (row i is agent i), or of each
run's (n, D) slice of a lattice (the reference vmaps the codec over the
runs; a row is a row either way):

  * ``identity`` — s = u; wire D·b bytes/row;
  * ``bf16``     — round-to-nearest bf16 cast; 2·D bytes/row;
  * ``int8``     — stochastic-rounding int8 with one f32 scale per row
    (scale = max|u_row|/127, q = ⌊u/scale + noise⌋, noise ~ U[0, 1));
    D + 4 bytes/row;
  * ``topk:R``   — the ⌈R·D⌉ entries of largest magnitude per row, ties
    broken by the lower index as ``jax.lax.top_k`` breaks them (values and
    int32 indices, R·D·(b + 4) bytes/row).

Unlike the reference, ``encode`` takes the int8 rounding noise as an
f32 tensor of u's shape rather than keys: the engines draw it from the
:class:`repro_torch.core.draws.Draws` object (``codec_noise``), so a test
can hand both packages the same numbers.  The flat int8 × 'pallas' path
mixes straight from the int8 payload with kernel #14
(:func:`repro_torch.kernels.ops.dequant_mix`); the lattice decodes s and
mixes it as the reference's does.  The tree engine compresses each leaf
as its own (n, D_leaf) rows (:func:`make_tree_ef_gossip`), so its int8
scales are per leaf-row and a compressed tree run differs from the flat
one, in the reference too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import build_tree, sorted_leaves, tree_map

__all__ = ["Compressor", "IdentityCompressor", "Bf16Compressor",
           "Int8Compressor", "TopKCompressor", "top_k_mask",
           "parse_compress",
           "COMPRESS_CHOICES", "init_residual", "init_residual_tree",
           "encode_compensated", "make_flat_ef_gossip",
           "make_tree_ef_gossip", "make_fused_ef_gossip"]

# canonical spellings for CLI help; 'topk:R' takes any ratio 0 < R <= 1
COMPRESS_CHOICES = ("none", "identity", "bf16", "int8", "topk:R")


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: encode (..., d) rows → wire payload; decode back to values.

    ``decode(encode(noise, u))`` is the dequantized s the mix consumes.
    Every codec works row by row over u's last dim, so u may be an (n, d)
    buffer or an (R, n, d) lattice.  ``needs_key`` marks the stochastic
    codec (int8), whose ``encode`` takes a U[0, 1) noise tensor of u's
    shape (or one that broadcasts to it); the others take ``None``.
    """

    name: str = "identity"
    needs_key: bool = False

    def encode(self, noise: torch.Tensor | None, u: torch.Tensor) -> Any:
        raise NotImplementedError

    def decode(self, payload: Any, dtype, d: int | None = None
               ) -> torch.Tensor:
        """Payload → dequantized values; ``d`` is the row width, which a
        codec that drops columns (top-k) cannot infer from the payload."""
        raise NotImplementedError

    def wire_bytes_per_row(self, d: int, param_bytes: int = 4) -> float:
        """Analytic payload bytes per agent row."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    name: str = "identity"

    def encode(self, noise, u):
        return u

    def decode(self, payload, dtype, d=None):
        return payload.to(dtype)

    def wire_bytes_per_row(self, d, param_bytes=4):
        return float(d * param_bytes)


@dataclasses.dataclass(frozen=True)
class Bf16Compressor(Compressor):
    name: str = "bf16"

    def encode(self, noise, u):
        return u.to(torch.bfloat16)

    def decode(self, payload, dtype, d=None):
        return payload.to(dtype)

    def wire_bytes_per_row(self, d, param_bytes=4):
        return 2.0 * d


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    """Stochastic-rounding int8 with one f32 scale per row.

    q = clip(⌊u/scale + noise⌋, −127, 127) with noise ~ U[0, 1) is
    unbiased (E[⌊y + U⌋] = y for |y| ≤ 127) and |q·scale − u| ≤ scale.
    """

    name: str = "int8"
    needs_key: bool = True

    @staticmethod
    def row_scale(u: torch.Tensor) -> torch.Tensor:
        """(...,) per-row scale max|u_row|/127; 1 on all-zero rows."""
        s = u.float().abs().amax(dim=-1) / 127.0
        return torch.where(s > 0, s, torch.ones_like(s))

    def encode(self, noise, u):
        from repro_torch.kernels import ref
        scale = self.row_scale(u)
        return {"q": ref.quantize_int8(u, noise, scale).to(torch.int8),
                "scale": scale}

    def decode(self, payload, dtype, d=None):
        s = payload["q"].float().mul_(payload["scale"][..., None])
        return s.to(dtype)

    def wire_bytes_per_row(self, d, param_bytes=4):
        return float(d) + 4.0  # int8 payload + one f32 scale


def top_k_mask(u: torch.Tensor, k: int) -> torch.Tensor:
    """(n, d) bool: the k entries of largest magnitude (in f32) of each
    row, the set ``jax.lax.top_k`` keeps: every entry above the k-th
    largest magnitude, then the entries equal to it in column order.
    ``torch.topk`` promises no order among ties, so it only finds that
    threshold."""
    mag = u.float().abs()
    top = torch.topk(mag, k, dim=1, sorted=False).values
    thr = top.amin(dim=1, keepdim=True)   # the k-th largest magnitude
    del top
    keep = mag > thr
    need = k - keep.sum(dim=1)            # ties at thr still to take
    rows, cols = torch.nonzero(mag == thr, as_tuple=True)
    del mag
    # rank of each tie within its row (nonzero lists them row-major)
    counts = torch.bincount(rows, minlength=u.shape[0])
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(rows.numel(), device=u.device) - start[rows]
    take = rank < need[rows]
    keep[rows[take], cols[take]] = True
    return keep


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Magnitude top-k: keep ⌈R·d⌉ entries per row, ties by lower index.

    The kept set is the one ``jax.lax.top_k`` keeps (:func:`top_k_mask`).
    The payload lists each row's indices in ascending order
    (the reference lists them by magnitude; the set is the same).  A
    lattice's rows are selected as the rows of its (R·n, d) view.
    """

    name: str = "topk"
    ratio: float = 0.1

    def k_of(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def keep_mask(self, u: torch.Tensor) -> torch.Tensor:
        """(n, d) bool: the k kept entries of each row."""
        return top_k_mask(u, self.k_of(u.shape[1]))

    def encode(self, noise, u):
        rows = u.reshape(-1, u.shape[-1])
        keep = self.keep_mask(rows)
        idx = torch.nonzero(keep)[:, 1].view(rows.shape[0], -1)
        del keep
        lead = u.shape[:-1] + (idx.shape[1],)
        return {"v": torch.gather(rows, 1, idx).view(lead),
                "i": idx.to(torch.int32).view(lead)}

    def decode(self, payload, dtype, d=None):
        if d is None:
            raise ValueError("top-k decode needs the row width d")
        vals, idx = payload["v"], payload["i"]
        k = vals.shape[-1]
        out = torch.zeros((vals.numel() // k, d), dtype=dtype,
                          device=vals.device)
        out.scatter_(1, idx.reshape(-1, k).long(),
                     vals.reshape(-1, k).to(dtype))
        return out.view(vals.shape[:-1] + (d,))

    def wire_bytes_per_row(self, d, param_bytes=4):
        return float(self.k_of(d)) * (param_bytes + 4.0)


def parse_compress(spec: str) -> Compressor | None:
    """'none' | 'identity' | 'bf16' | 'int8' | 'topk:R' → Compressor.

    'none' returns None: the engines then take the uncompressed path (no
    residual state).
    """
    if spec == "none":
        return None
    if spec == "identity":
        return IdentityCompressor()
    if spec == "bf16":
        return Bf16Compressor()
    if spec == "int8":
        return Int8Compressor()
    if spec.startswith("topk:"):
        try:
            ratio = float(spec[5:])
        except ValueError:
            ratio = -1.0
        if not 0.0 < ratio <= 1.0:
            raise ValueError(
                f"topk ratio must be in (0, 1]: {spec!r}")
        return TopKCompressor(ratio=ratio)
    raise ValueError(
        f"unknown gossip_compress {spec!r}; choose from "
        f"{'|'.join(COMPRESS_CHOICES)}")


def init_residual(compressor: Compressor | None, n_agents: int, d: int,
                  dtype, device="cpu") -> Any:
    """Zero EF residual buffer for the flat layout; () when uncompressed."""
    if compressor is None:
        return ()
    return torch.zeros((n_agents, d), dtype=dtype, device=device)


def init_residual_tree(compressor: Compressor | None, stacked) -> Any:
    """Zero EF residual tree matching a stacked (n, ...) params tree; ()
    when uncompressed (repro/core/compress.py:235-241)."""
    if compressor is None:
        return ()
    return tree_map(torch.zeros_like, stacked)


def encode_compensated(compressor: Compressor, p: torch.Tensor,
                       res: torch.Tensor, draws, t):
    """(u, payload): the error-compensated payload u = p + e and its
    encoding; the int8 codec's noise is ``draws.codec_noise(t, n, D)``
    ((n, D), or (R, n, D) from a lattice's draws)."""
    u = p + res
    noise = draws.codec_noise(t, u.shape[-2], u.shape[-1]) \
        if compressor.needs_key else None
    return u, compressor.encode(noise, u)


def make_flat_ef_gossip(compressor: Compressor, mix_fn: Callable,
                        n_agents: int, *,
                        fused_int8_pallas: bool = False) -> Callable:
    """Whole-buffer EF gossip: (w, p, res, draws, t) -> (y, new_res), on the
    flat (n, D) buffer or, with W (R, n, n), on an (R, n, D) lattice
    (repro/core/compress.py:247-295, repro/core/sweep.py:357-374).

    ``mix_fn(w, s) -> W @ s`` is the engine's resolved uncompressed mix; it
    applies the full W, diagonal included, and the wrapper adds the
    ``diag(W)·(p − s)`` term that swaps each agent's own compressed value
    back for its full-precision iterate.  The int8 noise is
    ``draws.codec_noise(t, n, D)``, drawn only by the int8 codec.

    ``fused_int8_pallas=True`` (the flat ``gossip_impl='pallas'`` × ``int8``)
    mixes straight from the int8 payload with kernel #14, so the f32 s is
    formed only for the residual.
    """
    use_fused = fused_int8_pallas and compressor.name == "int8"

    def gossip(w, p, res, draws, t):
        if p.shape[-2] != n_agents:
            raise ValueError(f"buffer of {p.shape[-2]} rows for {n_agents} "
                             f"agents")
        u, payload = encode_compensated(compressor, p, res, draws, t)
        if use_fused:
            from repro_torch.kernels import ops as kernel_ops
            y = kernel_ops.dequant_mix(w, payload["q"], payload["scale"], p)
            s = compressor.decode(payload, u.dtype, u.shape[-1])
            return y.to(p.dtype), u - s
        s = compressor.decode(payload, u.dtype, u.shape[-1])
        del payload
        diag = torch.diagonal(w, dim1=-2, dim2=-1).to(p.dtype)[..., None]
        y = mix_fn(w, s) + torch.sub(p, s).mul_(diag)
        return y, u - s

    return gossip


def make_tree_ef_gossip(compressor: Compressor, gossip_fn: Callable,
                        n_agents: int) -> Callable:
    """Leaf-wise EF gossip of the tree engine: (w, p_tree, res_tree, draws,
    t) -> (y_tree, new_res_tree) (repro/core/compress.py:291-328).

    Each leaf is compressed as its own (n, D_leaf) rows, its int8 noise
    ``draws.codec_noise(t, n, D_leaf, leaf=li)`` with ``li`` the leaf's
    position in jax.tree.flatten's order (sorted keys at every level).
    ``gossip_fn`` mixes the decoded tree s (the tree layout's resolved
    mix, kernel #1 leaf by leaf under 'pallas'); each leaf then gets the
    ``diag(W)·(p − s)`` correction.
    """
    def gossip(w, p_tree, res_tree, draws, t):
        paths, s_leaves, new_res = [], [], []
        res_leaves = dict(sorted_leaves(res_tree))
        for li, (path, p) in enumerate(sorted_leaves(p_tree)):
            if p.shape[0] != n_agents:
                raise ValueError(f"leaf {path} has {p.shape[0]} rows for "
                                 f"{n_agents} agents")
            u = (p + res_leaves[path]).reshape(n_agents, -1)
            noise = draws.codec_noise(t, n_agents, u.shape[1], leaf=li) \
                if compressor.needs_key else None
            payload = compressor.encode(noise, u)
            s = compressor.decode(payload, u.dtype, u.shape[1])
            del payload
            paths.append(path)
            s_leaves.append(s.view(p.shape))
            new_res.append((u - s).view(p.shape))
        s_tree = build_tree(paths, s_leaves)
        y_tree = gossip_fn(w, s_tree)
        diag = torch.diagonal(w)

        def correct(y, p, s):
            dg = diag.to(p.dtype).view((-1,) + (1,) * (p.ndim - 1))
            return y + torch.sub(p, s).mul_(dg)

        return (tree_map(correct, y_tree, p_tree, s_tree),
                build_tree(paths, new_res))

    return gossip


def make_fused_ef_gossip(compressor: Compressor, ef_kernel: Callable
                         ) -> Callable:
    """EF gossip in one mix pass: (w, p, res, draws, t) -> (y, new_res).

    The whole-row encode and decode in plain torch, then ``ef_kernel(w, p,
    s, u) -> (y, u − s)``: the EF mix kernel (#9/#11 on the (n, D) buffer,
    #10/#12 on an (R, n, D) lattice) forms the mix, the diagonal
    correction and the residual in one pass.
    """
    def gossip(w, p, res, draws, t):
        u, payload = encode_compensated(compressor, p, res, draws, t)
        s = compressor.decode(payload, u.dtype, u.shape[-1])
        del payload
        return ef_kernel(w, p, s, u)

    return gossip
