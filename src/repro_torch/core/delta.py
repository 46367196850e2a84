"""Delta-parameterized agent state: a shared base row (D,) and one encoded
delta per agent (repro/core/delta.py).

Each agent is ``base + delta_i``, and gossip moves the encoded delta
through the error-feedback exchange of core/compress.py: the codecs here
are :class:`repro_torch.core.compress.Compressor` objects that close over
the base row, so the flat engine's EF gossip (``make_flat_ef_gossip``,
and the fused EF kernels #9/#11) takes them unchanged.  The residual
carries what a lossy codec drops.

A :class:`DeltaSpec` picks the family:

  * ``full``       — the exact two-term delta (p_i, c_i), lossless bit
    for bit: 2·D·b bytes/row;
  * ``topk:K``     — the K largest |delta| entries per agent, ties to the
    lower index (values and int32 indices): K·(b + 4) bytes/row;
  * ``lowrank:R``  — delta_i reshaped to a near-square (d1, d2) matrix
    and its rank-R truncated SVD (U·Σ, Vᵀ): R·(d1 + d2)·b bytes/row.

``full`` is bit-exact in IEEE round-to-nearest arithmetic: ``encode``
stores p = fl(x − b) and c = fl(x − fl(b + p)), ``decode`` forms
fl(fl(b + p) + c).  fl(b + p) lies within a few ulps of x, so (Sterbenz)
the subtraction giving c is exact and the last addition lands on x.
Each step is its own elementwise torch op; nothing may fuse or
reassociate them.  With s == u the EF correction diag(W)·(p − s) is 0
and the exchange is the uncompressed mix.

:class:`DeltaStore` is the host-resident (numpy memmap) store of encoded
delta rows, with the reference's on-disk format (``save`` /
``restore``).  It is the population engine's store when ``delta !=
'none'`` (core/population.py: ``PopulationEngine(..., delta=...)``):
cohorts are decoded to dense rows on the way up and encoded on the way
back, so the delta is a storage format there and the cohort gossip runs
on the decoded rows; ``full`` gives the dense store's trajectory bit for
bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import compress as compress_lib

__all__ = ["DeltaSpec", "parse_delta", "DELTA_CHOICES", "factor_dims",
           "delta_store_bytes_per_row", "make_delta_codec",
           "FullDeltaCodec", "TopKDeltaCodec", "LowRankDeltaCodec",
           "DeltaStore"]

# canonical spellings for CLI help; K/R are positive integer counts/ranks
DELTA_CHOICES = ("none", "full", "topk:K", "lowrank:R")


@dataclasses.dataclass(frozen=True)
class DeltaSpec:
    """Validated delta parameterization: kind + rank/sparsity budget.

    ``rank`` is the kept-entry count K for 'topk' and the SVD rank R for
    'lowrank'; 0 (unused) for 'none'/'full'.
    """

    kind: str = "none"
    rank: int = 0

    def __post_init__(self):
        if self.kind not in ("none", "full", "topk", "lowrank"):
            raise ValueError(f"unknown delta kind {self.kind!r}")
        if self.kind in ("topk", "lowrank") and self.rank < 1:
            raise ValueError(
                f"delta {self.kind!r} needs a positive rank, "
                f"got {self.rank}")

    @property
    def is_lossless(self) -> bool:
        return self.kind in ("none", "full")

    @property
    def spec_str(self) -> str:
        if self.kind in ("none", "full"):
            return self.kind
        return f"{self.kind}:{self.rank}"


def parse_delta(spec: str) -> DeltaSpec:
    """'none' | 'full' | 'topk:K' | 'lowrank:R' → DeltaSpec."""
    if spec in ("none", "full"):
        return DeltaSpec(kind=spec)
    for kind in ("topk", "lowrank"):
        if spec.startswith(kind + ":"):
            try:
                rank = int(spec[len(kind) + 1:])
            except ValueError:
                rank = -1
            return DeltaSpec(kind=kind, rank=rank)  # validates rank >= 1
    raise ValueError(f"unknown delta spec {spec!r}; choose from "
                     f"{'|'.join(DELTA_CHOICES)}")


def factor_dims(d: int) -> tuple[int, int]:
    """Near-square (d1, d2) with d1·d2 = d, d1 <= d2 (the low-rank
    reshape): d1 is the largest divisor of d not above sqrt(d), so a
    prime d gives (1, d), where rank R saves nothing."""
    d1 = 1
    f = 1
    while f * f <= d:
        if d % f == 0:
            d1 = f
        f += 1
    return d1, d // d1


def delta_store_bytes_per_row(spec: DeltaSpec, d: int,
                              param_bytes: int = 4) -> float:
    """Per-agent payload bytes of the delta representation: the codec's
    wire bytes and a :class:`DeltaStore` row (the shared base and the
    staleness counter excluded)."""
    if spec.kind == "none":
        return float(d * param_bytes)
    if spec.kind == "full":
        return float(2 * d * param_bytes)
    if spec.kind == "topk":
        return float(min(spec.rank, d)) * (param_bytes + 4.0)
    d1, d2 = factor_dims(d)
    r = min(spec.rank, d1)
    return float(r * (d1 + d2) * param_bytes)


# ---------------------------------------------------------------------------
# Delta codecs (Compressor interface; each closes over the shared base row)
# ---------------------------------------------------------------------------


def _base_row(base: torch.Tensor, like: torch.Tensor, dtype) -> torch.Tensor:
    """The (1, D) base row on ``like``'s device in ``dtype``."""
    return base.to(device=like.device, dtype=dtype)[None, :]


@dataclasses.dataclass(frozen=True, eq=False)
class FullDeltaCodec(compress_lib.Compressor):
    """Exact two-term delta: payload (p, c) with decode == x bit for bit.

    p = fl(x − b) alone rounds, so c = fl(x − fl(b + p)) rides along and
    decode replays fl(fl(b + p) + c).  2·D·b bytes/row: the lossless
    anchor of the delta engine, not a compression.
    """

    name: str = "delta_full"
    base: torch.Tensor | None = None

    def encode(self, noise, u):
        b = _base_row(self.base, u, u.dtype)
        p = u - b
        c = b + p
        torch.sub(u, c, out=c)          # c = u − (b + p), its own op
        return {"p": p, "c": c}

    def decode(self, payload, dtype, d=None):
        p = payload["p"]
        s = _base_row(self.base, p, dtype) + p.to(dtype)
        return s.add_(payload["c"].to(dtype))   # (b + p) + c

    def wire_bytes_per_row(self, d, param_bytes=4):
        return float(2 * d * param_bytes)


@dataclasses.dataclass(frozen=True, eq=False)
class TopKDeltaCodec(compress_lib.Compressor):
    """Top-k sparse delta: the K largest |x − b| entries of each row.

    The kept set is ``lax.top_k``'s, ties to the lower index
    (:func:`repro_torch.core.compress.top_k_mask`); the payload lists
    each row's kept indices in ascending order (the reference lists them
    by magnitude; the set and the decoded row are the same).  The dropped
    mass goes to the EF residual.
    """

    name: str = "delta_topk"
    base: torch.Tensor | None = None
    k: int = 1

    def k_of(self, d: int) -> int:
        return max(1, min(d, self.k))

    def encode(self, noise, u):
        delta = u - _base_row(self.base, u, u.dtype)
        keep = compress_lib.top_k_mask(delta, self.k_of(u.shape[1]))
        idx = torch.nonzero(keep)[:, 1].view(u.shape[0], -1)
        del keep
        return {"v": torch.gather(delta, 1, idx), "i": idx.to(torch.int32)}

    def decode(self, payload, dtype, d=None):
        if d is None:
            raise ValueError("top-k delta decode needs the row width d")
        vals, idx = payload["v"], payload["i"]
        sparse = torch.zeros((vals.shape[0], d), dtype=dtype,
                             device=vals.device)
        sparse.scatter_(1, idx.long(), vals.to(dtype))
        return sparse.add_(_base_row(self.base, vals, dtype))  # b + sparse

    def wire_bytes_per_row(self, d, param_bytes=4):
        return float(self.k_of(d)) * (param_bytes + 4.0)


@dataclasses.dataclass(frozen=True, eq=False)
class LowRankDeltaCodec(compress_lib.Compressor):
    """Low-rank delta: the truncated SVD of the (d1, d2)-reshaped delta
    row, in f32.  Payload (U·Σ for the first R columns, Vᵀ for the first
    R rows) per agent, R·(d1 + d2)·b bytes/row: the best rank-R
    approximation in Frobenius norm.  SVD signs are not unique, so only
    the decoded row is comparable across implementations."""

    name: str = "delta_lowrank"
    base: torch.Tensor | None = None
    rank: int = 1

    def _dims(self, d: int) -> tuple[int, int, int]:
        d1, d2 = factor_dims(d)
        return d1, d2, min(self.rank, d1)

    def encode(self, noise, u):
        d1, d2, r = self._dims(u.shape[1])
        delta = u - _base_row(self.base, u, u.dtype)
        m = delta.to(torch.float32).view(u.shape[0], d1, d2)
        uu, s, vt = torch.linalg.svd(m, full_matrices=False)
        del m, delta
        return {"u": uu[:, :, :r] * s[:, None, :r],
                "v": vt[:, :r, :].contiguous()}

    def decode(self, payload, dtype, d=None):
        if d is None:
            raise ValueError("low-rank delta decode needs the row width d")
        lowrank = torch.bmm(payload["u"], payload["v"])
        delta = lowrank.view(lowrank.shape[0], -1).to(dtype)
        return delta.add_(_base_row(self.base, delta, dtype))  # b + delta

    def wire_bytes_per_row(self, d, param_bytes=4):
        d1, d2, r = self._dims(d)
        return float(r * (d1 + d2) * param_bytes)


def make_delta_codec(spec: DeltaSpec | str, base
                     ) -> compress_lib.Compressor | None:
    """DeltaSpec (or spec string) + base row → Compressor; None for
    'none'.  ``base`` is a tensor or an array of D values."""
    if isinstance(spec, str):
        spec = parse_delta(spec)
    base = torch.as_tensor(base).reshape(-1)
    if spec.kind == "none":
        return None
    if spec.kind == "full":
        return FullDeltaCodec(base=base)
    if spec.kind == "topk":
        return TopKDeltaCodec(base=base, k=spec.rank)
    return LowRankDeltaCodec(base=base, rank=spec.rank)


# ---------------------------------------------------------------------------
# Host-resident delta store (numpy, the population engine's backend)
# ---------------------------------------------------------------------------


def _np_topk_encode(rows: np.ndarray, base: np.ndarray, k: int):
    """Numpy top-k delta encoder: the stable argsort keeps lax.top_k's
    order, ties to the lower index."""
    delta = rows - base[None, :]
    order = np.argsort(-np.abs(delta.astype(np.float32)), axis=1,
                       kind="stable")
    idx = order[:, :k].astype(np.int32)
    vals = np.take_along_axis(delta, idx, axis=1)
    return vals, idx


class DeltaStore:
    """Host delta store: base (D,) + per-agent encoded payload memmaps.

    The dense (n_total, D) rows of a population store replaced by the
    DeltaSpec's payload:

      * ``full``       — p and c memmaps, (n_total, D) each (gather∘scatter
        is the identity bit for bit);
      * ``topk:K``     — (n_total, K) values + (n_total, K) int32 indices;
      * ``lowrank:R``  — (n_total, d1, R) and (n_total, R, d2) factors.

    ``gather`` decodes ids to dense rows; ``scatter`` encodes rows back
    (for the lossy kinds the truncation is the storage compression).
    """

    def __init__(self, spec: DeltaSpec, base: np.ndarray, payload: dict,
                 last_round: np.ndarray, path: str | None = None):
        self.spec = spec
        self.base = np.asarray(base).reshape(-1)
        self.payload = payload
        self.last_round = np.asarray(last_round, dtype=np.int64)
        self.path = path
        n = self.last_round.shape[0]
        for name, arr in payload.items():
            if arr.shape[0] != n:
                raise ValueError(f"payload[{name!r}] has leading dim "
                                 f"{arr.shape[0]}, expected {n}")

    @property
    def n_total(self) -> int:
        return self.last_round.shape[0]

    @property
    def d(self) -> int:
        return self.base.shape[0]

    @property
    def nbytes(self) -> int:
        """Live host bytes: base + payload memmaps + staleness counters."""
        return int(self.base.nbytes + self.last_round.nbytes
                   + sum(a.nbytes for a in self.payload.values()))

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, n_total: int, row_init: np.ndarray,
               spec: DeltaSpec | str, path: str | None = None,
               dtype=np.float32, chunk_rows: int = 65536) -> "DeltaStore":
        """z_i^1 = z^1 ∀i (Alg. 1 line 1): base = z^1, every delta = 0.

        ``path=None`` backs the payload with unlinked temporary files
        (their handles kept on the arrays); a ``path`` is a filename
        prefix, one file per payload leaf.
        """
        if isinstance(spec, str):
            spec = parse_delta(spec)
        if spec.kind == "none":
            raise ValueError("DeltaStore needs a non-'none' DeltaSpec; use "
                             "PopulationStore for the dense layout")
        base = np.asarray(row_init, dtype=dtype).reshape(-1)
        d = base.shape[0]

        def _memmap(name, shape, mdtype):
            if path is None:
                f = tempfile.NamedTemporaryFile(
                    prefix=f"delta_{name}_", suffix=".payload")
                arr = np.memmap(f, dtype=mdtype, mode="w+", shape=shape)
                arr._tmpfile = f  # keep the unlinked handle alive
            else:
                arr = np.memmap(f"{path}.{name}", dtype=mdtype, mode="w+",
                                shape=shape)
            return arr

        if spec.kind == "full":
            payload = {"p": _memmap("p", (n_total, d), dtype),
                       "c": _memmap("c", (n_total, d), dtype)}
        elif spec.kind == "topk":
            k = min(spec.rank, d)
            payload = {"v": _memmap("v", (n_total, k), dtype),
                       "i": _memmap("i", (n_total, k), np.int32)}
        else:
            d1, d2 = factor_dims(d)
            r = min(spec.rank, d1)
            payload = {"u": _memmap("u", (n_total, d1, r), dtype),
                       "v": _memmap("v", (n_total, r, d2), dtype)}
        # a zero delta encodes to all-zero payloads for every kind; chunked
        # writes keep the peak resident memory flat
        for arr in payload.values():
            for lo in range(0, n_total, chunk_rows):
                arr[lo:lo + chunk_rows] = 0
        last_round = np.full((n_total,), -1, dtype=np.int64)
        return cls(spec, base, payload, last_round, path=path)

    # -- the population engine's surface ------------------------------------

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Decode cohort ids to dense rows."""
        ids = np.asarray(ids)
        if self.spec.kind == "full":
            p = np.array(self.payload["p"][ids])
            c = np.array(self.payload["c"][ids])
            # FullDeltaCodec.decode's op order, so equal bit for bit
            return (self.base[None, :] + p) + c
        if self.spec.kind == "topk":
            vals = np.array(self.payload["v"][ids])
            idx = np.array(self.payload["i"][ids])
            rows = np.tile(self.base[None, :], (ids.shape[0], 1))
            np.put_along_axis(rows, idx,
                              np.take_along_axis(rows, idx, axis=1) + vals,
                              axis=1)
            return rows
        u = np.array(self.payload["u"][ids])
        v = np.array(self.payload["v"][ids])
        delta = np.einsum("nir,nrj->nij", u, v).reshape(ids.shape[0], -1)
        return self.base[None, :] + delta.astype(self.base.dtype)

    def scatter(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Encode finished rows back into the payload memmaps."""
        ids = np.asarray(ids)
        values = np.asarray(values, dtype=self.base.dtype)
        if self.spec.kind == "full":
            p = values - self.base[None, :]
            c = values - (self.base[None, :] + p)
            self.payload["p"][ids] = p
            self.payload["c"][ids] = c
            return
        if self.spec.kind == "topk":
            k = self.payload["v"].shape[1]
            vals, idx = _np_topk_encode(values, self.base, k)
            self.payload["v"][ids] = vals
            self.payload["i"][ids] = idx
            return
        d1 = self.payload["u"].shape[1]
        r = self.payload["u"].shape[2]
        m = (values - self.base[None, :]).astype(np.float32)
        m = m.reshape(values.shape[0], d1, -1)
        uu, s, vt = np.linalg.svd(m, full_matrices=False)
        self.payload["u"][ids] = uu[:, :, :r] * s[:, None, :r]
        self.payload["v"][ids] = vt[:, :r, :]

    def ages(self, ids: np.ndarray, round_idx: int) -> np.ndarray:
        """Participation age (rounds since last scheduled; never < 0)."""
        return np.maximum(
            round_idx - self.last_round[np.asarray(ids)], 0)

    # -- checkpointing (chunked; one .npy per payload leaf) -----------------

    def save(self, directory: str, step: int) -> str:
        out = os.path.join(directory, f"deltapop_{step:08d}")
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "base.npy"), self.base)
        np.save(os.path.join(out, "last_round.npy"), self.last_round)
        chunk = 65536
        for name, arr in self.payload.items():
            dst = np.lib.format.open_memmap(
                os.path.join(out, f"payload_{name}.npy"), mode="w+",
                dtype=arr.dtype, shape=arr.shape)
            for lo in range(0, arr.shape[0], chunk):
                dst[lo:lo + chunk] = arr[lo:lo + chunk]
            dst.flush()
        meta = {"kind": self.spec.kind, "rank": self.spec.rank,
                "n_total": self.n_total, "d": self.d, "step": step}
        with open(os.path.join(out, "meta.json"), "w") as f:
            json.dump(meta, f)
        return out

    @classmethod
    def restore(cls, directory: str, step: int | None = None, *,
                writable_path: str | None = None) -> "DeltaStore":
        if step is None:
            snaps = sorted(p for p in os.listdir(directory)
                           if p.startswith("deltapop_"))
            if not snaps:
                raise FileNotFoundError(
                    f"no deltapop_* checkpoints under {directory}")
            src = os.path.join(directory, snaps[-1])
        else:
            src = os.path.join(directory, f"deltapop_{step:08d}")
        with open(os.path.join(src, "meta.json")) as f:
            meta = json.load(f)
        spec = DeltaSpec(kind=meta["kind"], rank=meta["rank"])
        base = np.load(os.path.join(src, "base.npy"))
        store = cls.create(meta["n_total"], base, spec, path=writable_path,
                           dtype=base.dtype)
        chunk = 65536
        for name, arr in store.payload.items():
            saved = np.load(os.path.join(src, f"payload_{name}.npy"),
                            mmap_mode="r")
            for lo in range(0, arr.shape[0], chunk):
                arr[lo:lo + chunk] = saved[lo:lo + chunk]
        store.last_round[:] = np.load(os.path.join(src, "last_round.npy"))
        return store
