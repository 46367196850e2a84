"""Pytree checkpointing: msgpack + zstd, atomic writes, step discovery
(repro/checkpoint/checkpoint.py).

A tree is a nested dict of tensors, numpy arrays or scalars.
Each leaf is serialised as the reference serialises it, a dict
``{"__arr__": True, "dtype": <numpy name>, "shape": [...], "data": <raw
little-endian bytes>}``, with every dict's keys in sorted order (the
order ``jax.tree.map`` rebuilds them in), so both packages write the same
bytes for the same tree and read each other's files.  The whole blob is
zstd-compressed and written atomically (tmp + rename), so a killed run
never leaves a torn checkpoint.  ``load_checkpoint(like=...)`` casts each
leaf to the template's dtype and moves it to the template's device.

numpy has no bfloat16 and the port imports no ``ml_dtypes``: dtype names
map to torch dtypes here, and a bf16 tensor goes out and comes back
through its int16 bit pattern.  msgpack and zstandard are imported when a
checkpoint is written or read, never with this module.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.tree import build_tree, sorted_leaves

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "save_population", "load_population", "latest_population_step",
           "require_codecs", "tensor_from_numpy"]

# numpy dtype name -> torch dtype (numpy's names; 'bfloat16' is ml_dtypes')
DTYPES = {"bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
          "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32, "float64": torch.float64}
_NAMES = {v: k for k, v in DTYPES.items()}


def require_codecs():
    """(msgpack, zstandard), imported now; the reference's error when one
    is missing."""
    mods, missing = [], []
    for name in ("msgpack", "zstandard"):
        try:
            mods.append(__import__(name))
        except ImportError:
            missing.append(name)
    if missing:
        names = ", ".join(missing)
        raise ModuleNotFoundError(
            f"checkpointing needs {names} (pip install {' '.join(missing)});"
            " training runs without --ckpt-dir do not require them")
    return tuple(mods)


_STEP_RE = re.compile(r"^ckpt_(\d+)\.msgpack\.zst$")


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
    return {"__arr__": True, "dtype": name, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _unpack_leaf(d: dict) -> torch.Tensor:
    dtype = DTYPES[d["dtype"]]
    if not d["data"]:
        return torch.empty(d["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(d["data"]), dtype=dtype).reshape(
        d["shape"])


def _is_packed(x) -> bool:
    return isinstance(x, dict) and x.get("__arr__") is True


def _map(fn, tree, is_leaf=lambda x: False):
    """``fn`` on every leaf, dicts rebuilt in sorted key order (as
    ``jax.tree.map`` rebuilds them)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _map(fn, tree[k], is_leaf) for k in sorted(tree)}
    return fn(tree)


def save_checkpoint(directory: str, step: int, tree: Any,
                    level: int = 3) -> str:
    """Atomically write ``tree`` as ckpt_<step>.msgpack.zst; returns path."""
    msgpack, zstandard = require_codecs()
    os.makedirs(directory, exist_ok=True)
    payload = msgpack.packb(_map(_pack_leaf, tree), use_bin_type=True)
    blob = zstandard.ZstdCompressor(level=level).compress(payload)
    path = os.path.join(directory, f"ckpt_{step}.msgpack.zst")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def load_checkpoint(directory: str, step: int | None = None,
                    like: Any | None = None) -> Any:
    """Load a checkpoint as CPU tensors; ``step=None`` loads the latest.

    With ``like`` (a tree of tensors, dicts in any key order), each leaf
    is cast to the matching template leaf's dtype and moved to its device,
    and the result has the template's paths.
    """
    msgpack, zstandard = require_codecs()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}.msgpack.zst")
    with open(path, "rb") as f:
        payload = zstandard.ZstdDecompressor().decompress(f.read())
    raw = msgpack.unpackb(payload, raw=False)
    tree = _map(_unpack_leaf, raw, is_leaf=_is_packed)
    if like is None:
        return tree
    templ = list(sorted_leaves(like))
    flat = [leaf for _, leaf in sorted_leaves(tree)]
    if len(flat) != len(templ):
        raise ValueError(
            f"checkpoint has {len(flat)} leaves, template has "
            f"{len(templ)}")
    return build_tree([p for p, _ in templ], [
        leaf.to(device=ref.device, dtype=ref.dtype)
        for leaf, (_, ref) in zip(flat, templ)])


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def tensor_from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor of its dtype, a bfloat16 one (ml_dtypes')
    through its bit pattern."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


# ---------------------------------------------------------------------------
# Population-store checkpoints
#
# A population store is (n_total, D): at n_total = 1e6 that is ~100 MB of
# rows that must never be serialised through one giant buffer.  These
# helpers stream the rows in chunks to a raw little-endian .bin file (+ a
# JSON sidecar with dtype/shape/step and the staleness counters' dtype),
# inside a tmp directory that is atomically renamed into place.  No
# msgpack/zstd needed.  The store stays in numpy, as the reference's does.
# ---------------------------------------------------------------------------

_POP_RE = re.compile(r"^pop_(\d+)$")
_POP_CHUNK_ROWS = 65536


def save_population(directory: str, step: int, rows: np.ndarray,
                    last_round: np.ndarray,
                    chunk_rows: int = _POP_CHUNK_ROWS) -> str:
    """Chunk-stream the population store to ``<directory>/pop_<step>/``.

    ``rows`` is the (n_total, D) host store (ndarray or np.memmap);
    ``last_round`` the (n_total,) staleness counters.  Writes are sliced to
    ``chunk_rows`` rows so peak extra memory is one chunk, never the store.
    """
    import json
    import shutil

    rows = np.asarray(rows) if not isinstance(rows, np.memmap) else rows
    last_round = np.asarray(last_round)
    if rows.ndim != 2 or last_round.shape != (rows.shape[0],):
        raise ValueError(
            f"rows must be (n_total, D) with last_round (n_total,), got "
            f"{rows.shape} / {last_round.shape}")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"pop_{step}")
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"n_total": int(rows.shape[0]), "d": int(rows.shape[1]),
            "dtype": rows.dtype.name, "step": int(step),
            "last_round_dtype": last_round.dtype.name}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "rows.bin"), "wb") as f:
        for lo in range(0, rows.shape[0], chunk_rows):
            f.write(np.ascontiguousarray(
                rows[lo:lo + chunk_rows]).tobytes())
    with open(os.path.join(tmp, "last_round.bin"), "wb") as f:
        for lo in range(0, last_round.shape[0], chunk_rows):
            f.write(np.ascontiguousarray(
                last_round[lo:lo + chunk_rows]).tobytes())
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_population(directory: str, step: int | None = None, *,
                    mmap: bool = True
                    ) -> tuple[np.ndarray, np.ndarray, dict]:
    """Load ``(rows, last_round, meta)``; ``step=None`` loads the latest.

    ``mmap=True`` (default) maps rows.bin read-only: restoring a 1e6-row
    store costs no bulk read; ``mmap=False`` reads an in-memory copy.
    """
    import json

    if step is None:
        step = latest_population_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no population checkpoints in {directory}")
    path = os.path.join(directory, f"pop_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    shape = (meta["n_total"], meta["d"])
    dtype = np.dtype(meta["dtype"])
    rows_path = os.path.join(path, "rows.bin")
    if mmap:
        rows = np.memmap(rows_path, dtype=dtype, mode="r", shape=shape)
    else:
        rows = np.fromfile(rows_path, dtype=dtype).reshape(shape)
    last_round = np.fromfile(os.path.join(path, "last_round.bin"),
                             dtype=np.dtype(meta["last_round_dtype"]))
    return rows, last_round, meta


def latest_population_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _POP_RE.match(name))]
    return max(steps) if steps else None
