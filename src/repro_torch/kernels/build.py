"""Build the port's CUDA kernels with nvcc at first use and bind them.

Route: each ``csrc/*.cu`` compiles on its own (all started together) into
a shared library with a plain C interface for ``sm_90a``, loaded with
ctypes.  No PyTorch header is compiled, so a build takes seconds.  The
libraries go to ``build/kernels/<hash>/`` inside the checkout, keyed by a
hash of every file under ``csrc/`` and the flags: an edited source
rebuilds, an unchanged one loads as it is.  Nothing is built at import
time; the first CUDA launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_ROOT", "NVCC_FLAGS", "Built", "load"]

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gossip_mix", "update_mix", "compress_mix", "flash_attention",
           "ssd_scan", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "gossip_mix": {
        # w, x, y, r, n, d, dtype, stream
        "gossip_mix_dense": [_P, _P, _P, _I64, _I64, _I64, _INT, _P],
        # nbr, wv, wd, max_deg, x, y, r, n, d, dtype, stream
        "gossip_mix_ell": [_P, _P, _P, _I64, _P, _P, _I64, _I64, _I64, _INT,
                           _P],
    },
    "update_mix": {
        # w, x, g, m, eta, y, m_out, r, n, d, beta, nesterov, dtype, stream
        "update_mix_dense": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                             ctypes.c_float, _INT, _INT, _P],
        # nbr, wv, wd, max_deg, x, g, m, eta, y, m_out, r, n, d, beta,
        # nesterov, dtype, stream
        "update_mix_ell": [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _I64,
                           _I64, _I64, ctypes.c_float, _INT, _INT, _P],
    },
    "compress_mix": {
        # w, diag, p, s, u, y, res, r, n, d, dtype, stream
        "ef_mix_dense": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                         _P],
        # nbr, wv, wd, max_deg, p, s, u, y, res, r, n, d, dtype, stream
        "ef_mix_ell": [_P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
                       _I64, _INT, _P],
        # w, scale, u, noise, p, y, q, r, n, d, dtype, stream
        "quant_mix_dense": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                            _INT, _P],
        # w, scale, q, p, y, r, n, d, dtype, stream
        "dequant_mix_dense": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                              _P],
    },
    "flash_attention": {
        # q, k, v, out, b, s, h, kv, hd, window, scale, dtype, stream
        "flash_attention": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                            _I64, ctypes.c_float, _INT, _P],
    },
    "ssd_scan": {
        # x, dt, a, b, c, y, states, decay, batch, s, h, p, n, dtype, stream
        "ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                     _I64, _INT, _P],
        # s, p, n, dtype, out (2 int64: chunks, scratch floats per chunk)
        "ssd_scan_scratch": [_I64, _I64, _I64, _INT, _P],
    },
    "rglru_scan": {
        # a, bx, h, h_last, batch, s, w, dtype, stream
        "rglru_scan": [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _P],
    },
}


@dataclasses.dataclass(frozen=True)
class Built:
    """The loaded kernel libraries and what building them reported."""

    libs: dict            # source stem -> ctypes.CDLL with bound signatures
    directory: Path
    ptxas_log: str        # nvcc -Xptxas -v output (registers, spills)
    build_seconds: float  # 0.0 when the libraries were already built


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
            "CUDA kernels are built from source for sm_90a at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(stems, out: Path) -> str:
    """One nvcc per source, all at once; atomic rename into ``out``."""
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem in stems:
        tmp = out / f".lib{stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, tmp, proc))
    logs, failed = [], []
    for stem, tmp, proc in jobs:
        text, _ = proc.communicate()
        logs.append(f"== {stem}.cu ==\n{text}")
        if proc.returncode:
            failed.append(stem)
        else:
            os.replace(tmp, out / f"lib{stem}.so")
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    return log


def _bind(lib: ctypes.CDLL, stem: str) -> ctypes.CDLL:
    for fn_name, argtypes in _SIGNATURES[stem].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (if needed) and load every kernel library, once per process."""
    out = BUILD_ROOT / _digest()
    missing = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
    seconds = 0.0
    if missing:
        t0 = time.perf_counter()
        log = _compile(missing, out)
        seconds = time.perf_counter() - t0
        (out / "ptxas.log").write_text(log)
    log_path = out / "ptxas.log"
    log = log_path.read_text() if log_path.exists() else ""
    libs = {s: _bind(ctypes.CDLL(str(out / f"lib{s}.so")), s)
            for s in SOURCES}
    return Built(libs=libs, directory=out, ptxas_log=log,
                 build_seconds=seconds)
