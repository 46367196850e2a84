"""Wrappers of the port's CUDA kernels (counterpart of repro/kernels/ops.py).

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
version in :mod:`repro_torch.kernels.ref`; a CUDA tensor launches the
kernel built from ``csrc/`` or raises.  There is no fallback from one to
the other.  Unlike the reference, nothing is padded: the kernels mask the
ragged edge of D themselves, and reject an n beyond their shared memory
(``kMaxN`` in ``csrc/mix_common.cuh``) with an error the wrapper raises.

Every kernel wrapper carries a ``launches`` counter that it advances by
one each time its kernel is launched (CPU calls do not count);
:func:`launch_counts` / :func:`reset_launch_counts` read and clear them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

__all__ = ["gossip_mix", "gossip_mix_sparse", "update_mix",
           "update_mix_sparse", "ell_table", "ell_weights",
           "make_sparse_gossip", "make_sparse_update_mix", "launch_counts",
           "reset_launch_counts"]


def _check_buffer(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype} (the kernels "
                        f"take the f32 flat buffer only)")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def _on_cuda(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA ones (kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
    if x.device.type == "cpu":
        return False
    for t in (x,) + others:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        hint = (" (cudaErrorInvalidValue: the kernel rejects these "
                "arguments, e.g. more agents than kMaxN)" if rc == 1 else "")
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {rc}{hint}")


def _eta_tensor(eta, x: torch.Tensor) -> torch.Tensor:
    eta = torch.as_tensor(eta, dtype=torch.float32, device=x.device)
    if eta.numel() != 1:
        raise ValueError(f"eta must hold one value, got shape "
                         f"{tuple(eta.shape)}")
    return eta.reshape(1)


def _check_ell(nbr, wv, wd, n: int) -> int:
    if nbr.dtype != torch.int32 or nbr.ndim != 2 or nbr.shape[0] != n:
        raise ValueError(f"nbr must be (n={n}, max_deg) int32, got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    max_deg = nbr.shape[1]
    if max_deg < 1:
        raise ValueError("the ELL table needs max_deg >= 1")
    _check_buffer("wv", wv, (n, max_deg))
    _check_buffer("wd", wd, (n,))
    return max_deg


def gossip_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """#1 y = W @ X for the (n, D) flat buffer (kernel: gossip_mix.cu)."""
    n, d = x.shape
    _check_buffer("x", x, (n, d))
    _check_buffer("w", w, (n, n))
    if not _on_cuda(x, w):
        return ref.gossip_mix(w, x)
    y = torch.empty_like(x)
    lib = build.load().libs["gossip_mix"]
    rc = lib.gossip_mix_dense(w.data_ptr(), x.data_ptr(), y.data_ptr(), n, d,
                              _stream(x))
    _raise_on(rc, "gossip_mix")
    gossip_mix.launches += 1
    return y


def gossip_mix_sparse(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """#2 ELL mix y_i = wd_i x_i + Σ_k wv[i, k] x[nbr[i, k]]
    (kernel: gossip_mix.cu)."""
    n, d = x.shape
    _check_buffer("x", x, (n, d))
    max_deg = _check_ell(nbr, wv, wd, n)
    if not _on_cuda(x, nbr, wv, wd):
        return ref.gossip_mix_sparse(nbr, wv, wd, x)
    y = torch.empty_like(x)
    lib = build.load().libs["gossip_mix"]
    rc = lib.gossip_mix_ell(nbr.data_ptr(), wv.data_ptr(), wd.data_ptr(),
                            max_deg, x.data_ptr(), y.data_ptr(), n, d,
                            _stream(x))
    _raise_on(rc, "gossip_mix_sparse")
    gossip_mix_sparse.launches += 1
    return y


def _update_args(x, g, eta, m, beta):
    n, d = x.shape
    _check_buffer("x", x, (n, d))
    _check_buffer("g", g, (n, d))
    if beta is not None:
        if m is None:
            raise ValueError("momentum step (beta set) needs the buffer m")
        _check_buffer("m", m, (n, d))
    elif m is not None:
        raise ValueError("momentum buffer passed without beta")
    return n, d, _eta_tensor(eta, x)


def update_mix(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    """#3 y = W @ (x − η·g), or the momentum/nesterov step emitting
    (y, m') (kernel: update_mix.cu)."""
    n, d, eta = _update_args(x, g, eta, m, beta)
    _check_buffer("w", w, (n, n))
    extra = () if m is None else (m,)
    if not _on_cuda(x, w, g, eta, *extra):
        return ref.update_mix(w, x, g, eta, m, beta=beta, nesterov=nesterov)
    y = torch.empty_like(x)
    m_out = None if m is None else torch.empty_like(m)
    lib = build.load().libs["update_mix"]
    rc = lib.update_mix_dense(
        w.data_ptr(), x.data_ptr(), g.data_ptr(),
        None if m is None else m.data_ptr(), eta.data_ptr(), y.data_ptr(),
        None if m_out is None else m_out.data_ptr(), n, d,
        0.0 if beta is None else float(beta),
        int(bool(nesterov)), _stream(x))
    _raise_on(rc, "update_mix")
    update_mix.launches += 1
    return y if m is None else (y, m_out)


def update_mix_sparse(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                      nesterov=False):
    """#4 the fused step with the ELL mix (kernel: update_mix.cu)."""
    n, d, eta = _update_args(x, g, eta, m, beta)
    max_deg = _check_ell(nbr, wv, wd, n)
    extra = () if m is None else (m,)
    if not _on_cuda(x, nbr, wv, wd, g, eta, *extra):
        return ref.update_mix_sparse(nbr, wv, wd, x, g, eta, m, beta=beta,
                                     nesterov=nesterov)
    y = torch.empty_like(x)
    m_out = None if m is None else torch.empty_like(m)
    lib = build.load().libs["update_mix"]
    rc = lib.update_mix_ell(
        nbr.data_ptr(), wv.data_ptr(), wd.data_ptr(), max_deg, x.data_ptr(),
        g.data_ptr(), None if m is None else m.data_ptr(), eta.data_ptr(),
        y.data_ptr(), None if m_out is None else m_out.data_ptr(), n, d,
        0.0 if beta is None else float(beta),
        int(bool(nesterov)), _stream(x))
    _raise_on(rc, "update_mix_sparse")
    update_mix_sparse.launches += 1
    return y if m is None else (y, m_out)


_KERNEL_WRAPPERS = (gossip_mix, gossip_mix_sparse, update_mix,
                    update_mix_sparse)


def reset_launch_counts() -> None:
    for fn in _KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _KERNEL_WRAPPERS}


reset_launch_counts()


# ---------------------------------------------------------------------------
# ELL tables (the reference's ops.py:_ell_table/_ell_weights, unpadded)
# ---------------------------------------------------------------------------


def ell_table(adjacency) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (nbr, mask), both (n, max_deg): row i lists its neighbours
    in ascending order; padded slots point at i itself and are masked."""
    adj = np.asarray(adjacency, dtype=bool)
    n = adj.shape[0]
    max_deg = max(int(adj.sum(axis=1).max()) if n else 0, 1)
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_deg))
    mask = np.zeros((n, max_deg), dtype=bool)
    for i in range(n):
        js = np.flatnonzero(adj[i])
        nbr[i, :len(js)] = js
        mask[i, :len(js)] = True
    return nbr, mask


def ell_weights(w: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor):
    """Live (wv, wd) from the sampled (n, n) W: failed links read 0."""
    wf = w.float()
    wv = torch.where(mask, torch.gather(wf, 1, nbr.long()),
                     torch.zeros((), dtype=wf.dtype, device=wf.device))
    return wv.contiguous(), torch.diagonal(wf).contiguous()


class _EllTables:
    """The graph's ELL table, moved once to each device that asks for it."""

    def __init__(self, adjacency):
        self.nbr, self.mask = ell_table(adjacency)
        self.n = self.nbr.shape[0]
        self._on = {}

    def on(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (torch.as_tensor(self.nbr, device=device),
                                torch.as_tensor(self.mask, device=device))
        return self._on[device]

    def weights(self, w: torch.Tensor, x: torch.Tensor):
        if x.shape[0] != self.n:
            raise ValueError(f"buffer has {x.shape[0]} rows, graph has "
                             f"{self.n} agents")
        nbr, mask = self.on(x.device)
        wv, wd = ell_weights(w, nbr, mask)
        return nbr, wv, wd


def make_sparse_gossip(graph):
    """mix(w, x) over the graph's static ELL table (kernel #2 on CUDA),
    reading the live edge weights from the sampled W every call."""
    tables = _EllTables(graph.adjacency)

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        nbr, wv, wd = tables.weights(w, x)
        return gossip_mix_sparse(nbr, wv, wd, x)

    return mix


def make_sparse_update_mix(graph, *, beta=None, nesterov=False):
    """fused(w, x, g, eta, m=None) over the graph's ELL table (kernel #4
    on CUDA)."""
    tables = _EllTables(graph.adjacency)

    def fused(w, x, g, eta, m=None):
        nbr, wv, wd = tables.weights(w, x)
        return update_mix_sparse(nbr, wv, wd, x, g, eta, m, beta=beta,
                                 nesterov=nesterov)

    return fused
