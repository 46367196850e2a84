"""Wrappers of the port's CUDA kernels (counterpart of repro/kernels/ops.py).

Dispatch is by the device of the tensors: a CPU tensor goes to the plain
version in :mod:`repro_torch.kernels.ref`; a CUDA tensor launches the
kernel built from ``csrc/`` or raises.  There is no fallback from one to
the other.  Unlike the reference, nothing is padded: the kernels mask the
ragged edge of D themselves, and reject an n beyond their shared memory
(``kMaxN`` in ``csrc/mix_common.cuh``) with an error the wrapper raises.
The batched wrappers (#5–#8) launch the same CUDA functions over the
leading run axis of an (R, n, D) sweep lattice: one launch for all runs.
The compressed-gossip wrappers (#9, #11, #13, #14) take the (n, D)
buffers of the error-feedback exchange and the int8 payload; #10/#12
launch #9/#11's CUDA functions over a lattice's run axis.  The model
zoo's prefill wrappers (#15 flash attention, #16 the SSD scan, #17 the
RG-LRU scan) take f32 or bf16 activations and are forward only: they
raise when an input requires grad under grad mode, on any device, as the
reference's Pallas kernels have no backward.

Every kernel wrapper carries a ``launches`` counter that it advances by
one each time its kernel is launched (CPU calls do not count);
:func:`launch_counts` / :func:`reset_launch_counts` read and clear them.

The mix kernels (#1–#14) take f32, f64 or bf16 buffers and raise on any
other dtype (float16 among them), on the card and on the CPU alike.  They
do what the reference's Pallas kernels do with each: load and store the
buffer's dtype and mix in f32, with W and the ELL weights cast to f32 (so
a float64 buffer, as the paper's linear-regression figures run, launches
the same kernels; the exact f64 mix is the 'dense' gossip_impl's plain
product).  W stays f32 for a bf16 buffer too, as the reference's Pallas
route keeps it, where its 'dense' impl rounds W to bf16 first: the two
routes differ in bf16, in the reference as here.  The momentum, η, the
int8 scales and the rounding noise are f32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.tree import tree_map

__all__ = ["gossip_mix", "gossip_mix_tree", "gossip_mix_sparse", "update_mix",
           "update_mix_sparse", "gossip_mix_batched",
           "gossip_mix_sparse_batched", "update_mix_batched",
           "update_mix_sparse_batched", "ell_table", "ell_weights",
           "EllTables", "make_sparse_gossip", "make_sparse_update_mix",
           "make_sparse_gossip_batched", "make_sparse_update_mix_batched",
           "ef_mix", "ef_mix_sparse", "make_sparse_ef_mix", "quant_mix",
           "dequant_mix", "ef_mix_batched", "ef_mix_sparse_batched",
           "make_sparse_ef_mix_batched", "flash_attention", "ssd_scan",
           "rglru_scan", "launch_counts", "reset_launch_counts"]

# the mix kernels' buffer dtypes and their codes (feddec::Dtype in
# csrc/mix_common.cuh)
_MIX_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_MIX_DTYPE_NAMES = "bfloat16, float32 or float64"


def _check_buffer(name: str, t: torch.Tensor, shape: tuple,
                  dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def _weights(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """W or an ELL weight table cast to the kernels' f32, as the
    reference's kernels cast it; f32, f64 and bf16 are taken.  A strided
    view (the sharded engine's own block W[rows, rows], core/sharded.py)
    is copied to a contiguous block on its own device: (n, n) floats
    beside an (n, D) buffer."""
    if t.dtype not in _MIX_DTYPES:
        raise TypeError(f"{name} must be {_MIX_DTYPE_NAMES}, got {t.dtype}")
    _check_buffer(name, t, shape, t.dtype)
    return t.to(torch.float32).contiguous()


def _lattice(x: torch.Tensor, ndim: int,
             name: str = "x") -> tuple[int, int, int, int]:
    """(R, n, D, dtype code) of an (n, D) buffer (R = 1) or an (R, n, D)
    lattice, f32, f64 or bf16."""
    if x.ndim != ndim:
        raise ValueError(f"{name} must be "
                         f"{'(n, D)' if ndim == 2 else '(R, n, D)'}, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in _MIX_DTYPES:
        raise TypeError(f"{name} must be {_MIX_DTYPE_NAMES}, got {x.dtype} "
                        f"(the kernels take the bf16, f32 or f64 flat "
                        f"buffer)")
    r = 1 if ndim == 2 else x.shape[0]
    return r, x.shape[-2], x.shape[-1], _MIX_DTYPES[x.dtype]


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


def _plain(fn):
    """The plain version of the mix wrapper ``fn``: kernels/ref.py has one
    of each name (the ``*_batched`` ones run the single-run one per run)."""
    return getattr(ref, fn.__name__)


def _eta_tensor(eta, x: torch.Tensor, r: int) -> torch.Tensor:
    """η as an (r,) f32 tensor on x's device: one step size per run."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=x.device)
    if eta.numel() != r:
        raise ValueError(f"eta must hold {r} value(s), one per run, got "
                         f"shape {tuple(eta.shape)}")
    return eta.reshape(r).contiguous()


def _check_ell(nbr, wv, wd, lead: tuple, n: int):
    """(max_deg, wv, wd) of an ELL table, the weights cast to f32."""
    if (nbr.dtype != torch.int32 or nbr.ndim != len(lead) + 2
            or tuple(nbr.shape[:-1]) != lead + (n,)):
        raise ValueError(f"nbr must be {lead + (n,)} + (max_deg,) int32, got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    max_deg = nbr.shape[-1]
    if max_deg < 1:
        raise ValueError("the ELL table needs max_deg >= 1")
    return (max_deg, _weights("wv", wv, lead + (n, max_deg)),
            _weights("wd", wd, lead + (n,)))


def _gossip(fn, ndim, w, x):
    """Kernels #1 (ndim 2) and #5 (ndim 3): y = W @ X per run."""
    r, n, d, dtype = _lattice(x, ndim)
    w = _weights("w", w, x.shape[:-2] + (n, n))
    if not _on_cuda(x, w):
        return _plain(fn)(w, x)
    y = torch.empty_like(x)
    lib = build.load().libs["gossip_mix"]
    rc = lib.gossip_mix_dense(w.data_ptr(), x.data_ptr(), y.data_ptr(), r, n,
                              d, dtype, _stream(x))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y


def _gossip_sparse(fn, ndim, nbr, wv, wd, x):
    """Kernels #2 and #6: the ELL mix per run."""
    r, n, d, dtype = _lattice(x, ndim)
    max_deg, wv, wd = _check_ell(nbr, wv, wd, x.shape[:-2], n)
    if not _on_cuda(x, nbr, wv, wd):
        return _plain(fn)(nbr, wv, wd, x)
    y = torch.empty_like(x)
    lib = build.load().libs["gossip_mix"]
    rc = lib.gossip_mix_ell(nbr.data_ptr(), wv.data_ptr(), wd.data_ptr(),
                            max_deg, x.data_ptr(), y.data_ptr(), r, n, d,
                            dtype, _stream(x))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y


def _update_args(ndim, x, g, eta, m, beta):
    r, n, d, dtype = _lattice(x, ndim)
    _check_buffer("g", g, tuple(x.shape), x.dtype)
    if beta is not None:
        if m is None:
            raise ValueError("momentum step (beta set) needs the buffer m")
        _check_buffer("m", m, tuple(x.shape))
    elif m is not None:
        raise ValueError("momentum buffer passed without beta")
    return r, n, d, dtype, _eta_tensor(eta, x, r)


def _update(fn, ndim, w, x, g, eta, m, beta, nesterov):
    """Kernels #3 and #7: y = W @ local_step(x, g) per run (and m')."""
    r, n, d, dtype, eta = _update_args(ndim, x, g, eta, m, beta)
    w = _weights("w", w, x.shape[:-2] + (n, n))
    extra = () if m is None else (m,)
    if not _on_cuda(x, w, g, eta, *extra):
        return _plain(fn)(w, x, g, eta, m, beta=beta, nesterov=nesterov)
    y = torch.empty_like(x)
    m_out = None if m is None else torch.empty_like(m)
    lib = build.load().libs["update_mix"]
    rc = lib.update_mix_dense(
        w.data_ptr(), x.data_ptr(), g.data_ptr(),
        None if m is None else m.data_ptr(), eta.data_ptr(), y.data_ptr(),
        None if m_out is None else m_out.data_ptr(), r, n, d,
        0.0 if beta is None else float(beta),
        int(bool(nesterov)), dtype, _stream(x))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y if m is None else (y, m_out)


def _update_sparse(fn, ndim, nbr, wv, wd, x, g, eta, m, beta, nesterov):
    """Kernels #4 and #8: the fused step with the ELL mix per run."""
    r, n, d, dtype, eta = _update_args(ndim, x, g, eta, m, beta)
    max_deg, wv, wd = _check_ell(nbr, wv, wd, x.shape[:-2], n)
    extra = () if m is None else (m,)
    if not _on_cuda(x, nbr, wv, wd, g, eta, *extra):
        return _plain(fn)(nbr, wv, wd, x, g, eta, m, beta=beta,
                          nesterov=nesterov)
    y = torch.empty_like(x)
    m_out = None if m is None else torch.empty_like(m)
    lib = build.load().libs["update_mix"]
    rc = lib.update_mix_ell(
        nbr.data_ptr(), wv.data_ptr(), wd.data_ptr(), max_deg, x.data_ptr(),
        g.data_ptr(), None if m is None else m.data_ptr(), eta.data_ptr(),
        y.data_ptr(), None if m_out is None else m_out.data_ptr(), r, n, d,
        0.0 if beta is None else float(beta),
        int(bool(nesterov)), dtype, _stream(x))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y if m is None else (y, m_out)


def gossip_mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """#1 y = W @ X for the (n, D) flat buffer (kernel: gossip_mix.cu)."""
    return _gossip(gossip_mix, 2, w, x)


def gossip_mix_tree(w: torch.Tensor, stacked):
    """#1 leaf by leaf over a stacked tree (a tensor or a dict of (n, ...)
    leaves), repro/kernels/ops.py:156-167: each leaf is viewed as its
    contiguous (n, D_leaf) rows and mixed by :func:`gossip_mix`, one
    launch per leaf on the card (its plain version on the CPU).  Nothing
    is padded: the kernel masks a ragged D_leaf, however narrow."""
    def mix(leaf: torch.Tensor) -> torch.Tensor:
        rows = leaf.contiguous().view(leaf.shape[0], -1)
        return gossip_mix(w, rows).view(leaf.shape)

    return tree_map(mix, stacked)


def gossip_mix_sparse(nbr: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """#2 ELL mix y_i = wd_i x_i + Σ_k wv[i, k] x[nbr[i, k]]
    (kernel: gossip_mix.cu)."""
    return _gossip_sparse(gossip_mix_sparse, 2, nbr, wv, wd, x)


def update_mix(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    """#3 y = W @ (x − η·g), or the momentum/nesterov step emitting
    (y, m') (kernel: update_mix.cu)."""
    return _update(update_mix, 2, w, x, g, eta, m, beta, nesterov)


def update_mix_sparse(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                      nesterov=False):
    """#4 the fused step with the ELL mix (kernel: update_mix.cu)."""
    return _update_sparse(update_mix_sparse, 2, nbr, wv, wd, x, g, eta, m,
                          beta, nesterov)


def gossip_mix_batched(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """#5 y[r] = W[r] @ X[r] for the (R, n, D) lattice buffer and (R, n, n)
    W, one launch for all R runs (kernel: gossip_mix.cu)."""
    return _gossip(gossip_mix_batched, 3, w, x)


def gossip_mix_sparse_batched(nbr, wv, wd, x):
    """#6 the ELL mix per run: nbr/wv (R, n, max_deg) padded to the
    lattice's max degree, wd (R, n); one launch (kernel: gossip_mix.cu)."""
    return _gossip_sparse(gossip_mix_sparse_batched, 3, nbr, wv, wd, x)


def update_mix_batched(w, x, g, eta, m=None, *, beta=None, nesterov=False):
    """#7 #3 per run: W (R, n, n), x/g (R, n, D), η (R,), m (R, n, D) f32;
    one launch (kernel: update_mix.cu)."""
    return _update(update_mix_batched, 3, w, x, g, eta, m, beta, nesterov)


def update_mix_sparse_batched(nbr, wv, wd, x, g, eta, m=None, *, beta=None,
                              nesterov=False):
    """#8 #4 per run with per-run ELL tables; one launch
    (kernel: update_mix.cu)."""
    return _update_sparse(update_mix_sparse_batched, 3, nbr, wv, wd, x, g,
                          eta, m, beta, nesterov)


# ---------------------------------------------------------------------------
# Compressed gossip: kernels #9–#12 (EF receive side), #13, #14 (int8)
# ---------------------------------------------------------------------------


def _ef_buffers(ndim, p, s, u):
    r, n, d, dtype = _lattice(p, ndim, "p")
    for name, t in (("s", s), ("u", u)):
        _check_buffer(name, t, tuple(p.shape), p.dtype)
    return r, n, d, dtype


def _ef(fn, ndim, w, p, s, u):
    """Kernels #9 (ndim 2) and #10 (ndim 3): the EF receive side per run."""
    r, n, d, dtype = _ef_buffers(ndim, p, s, u)
    w32 = _weights("w", w, p.shape[:-2] + (n, n))
    if not _on_cuda(p, w, s, u):
        return _plain(fn)(w, p, s, u)
    # W_ii in p's dtype, from W as given (the reference's diag input)
    diag = torch.diagonal(w, dim1=-2, dim2=-1).to(p.dtype).contiguous()
    y, res = torch.empty_like(p), torch.empty_like(p)
    lib = build.load().libs["compress_mix"]
    rc = lib.ef_mix_dense(
        w32.data_ptr(), diag.data_ptr(), p.data_ptr(), s.data_ptr(),
        u.data_ptr(), y.data_ptr(), res.data_ptr(), r, n, d, dtype,
        _stream(p))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y, res


def _ef_sparse(fn, ndim, nbr, wv, wd, p, s, u):
    """Kernels #11 and #12: the EF receive side with the ELL mix per run."""
    r, n, d, dtype = _ef_buffers(ndim, p, s, u)
    max_deg, wv, wd = _check_ell(nbr, wv, wd, p.shape[:-2], n)
    if not _on_cuda(p, nbr, wv, wd, s, u):
        return _plain(fn)(nbr, wv, wd, p, s, u)
    y, res = torch.empty_like(p), torch.empty_like(p)
    lib = build.load().libs["compress_mix"]
    rc = lib.ef_mix_ell(
        nbr.data_ptr(), wv.data_ptr(), wd.data_ptr(), max_deg, p.data_ptr(),
        s.data_ptr(), u.data_ptr(), y.data_ptr(), res.data_ptr(), r, n, d,
        dtype, _stream(p))
    _raise_on(rc, fn.__name__)
    fn.launches += 1
    return y, res


def ef_mix(w: torch.Tensor, p: torch.Tensor, s: torch.Tensor,
           u: torch.Tensor):
    """#9 (y, r) = ((W s)→p.dtype + diag(W)·(p − s), u − s) in one pass over
    the (n, D) buffers (kernel: compress_mix.cu)."""
    return _ef(ef_mix, 2, w, p, s, u)


def ef_mix_sparse(nbr, wv, wd, p, s, u):
    """#11 the ELL form of #9, wd doubling as diag(W)
    (kernel: compress_mix.cu)."""
    return _ef_sparse(ef_mix_sparse, 2, nbr, wv, wd, p, s, u)


def ef_mix_batched(w, p, s, u):
    """#10 #9 per run: W (R, n, n), p/s/u (R, n, D); one launch for all R
    runs (kernel: compress_mix.cu)."""
    return _ef(ef_mix_batched, 3, w, p, s, u)


def ef_mix_sparse_batched(nbr, wv, wd, p, s, u):
    """#12 #11 per run: nbr/wv (R, n, max_deg) padded to the lattice's max
    degree, wd (R, n), p/s/u (R, n, D); one launch
    (kernel: compress_mix.cu)."""
    return _ef_sparse(ef_mix_sparse_batched, 3, nbr, wv, wd, p, s, u)


def quant_mix(w, u, noise, p, scale):
    """#13 the int8 send side: (y, q) with q = clip(⌊u/scale + noise⌋, ±127)
    int8 and y = W (q·scale) + diag(W)·(p − q·scale), in f32 and y cast to
    p's dtype; the f32 noise and per-row scales come from the caller
    (kernel: compress_mix.cu)."""
    r, n, d, dtype = _lattice(p, 2, "p")
    _check_buffer("u", u, (n, d), p.dtype)
    _check_buffer("noise", noise, (n, d))
    w = _weights("w", w, (n, n))
    _check_buffer("scale", scale, (n,))
    if not _on_cuda(u, w, noise, p, scale):
        return ref.quant_mix(w, u, noise, p, scale)
    y = torch.empty_like(p)
    q = torch.empty(u.shape, dtype=torch.int8, device=u.device)
    lib = build.load().libs["compress_mix"]
    rc = lib.quant_mix_dense(
        w.data_ptr(), scale.data_ptr(), u.data_ptr(), noise.data_ptr(),
        p.data_ptr(), y.data_ptr(), q.data_ptr(), r, n, d, dtype, _stream(u))
    _raise_on(rc, "quant_mix")
    quant_mix.launches += 1
    return y, q


def dequant_mix(w, q, scale, p):
    """#14 the int8 receive side: y = W (q·scale) + diag(W)·(p − q·scale),
    in f32 and cast to p's dtype, reading the int8 payload q at 1 B per
    element (kernel: compress_mix.cu)."""
    r, n, d, dtype = _lattice(p, 2, "p")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if tuple(q.shape) != (n, d):
        raise ValueError(f"q has shape {tuple(q.shape)}, expected {(n, d)}")
    w = _weights("w", w, (n, n))
    _check_buffer("scale", scale, (n,))
    if not _on_cuda(p, w, q, scale):
        return ref.dequant_mix(w, q, scale, p)
    y = torch.empty_like(p)
    lib = build.load().libs["compress_mix"]
    rc = lib.dequant_mix_dense(
        w.data_ptr(), scale.data_ptr(), q.data_ptr(), p.data_ptr(),
        y.data_ptr(), r, n, d, dtype, _stream(p))
    _raise_on(rc, "dequant_mix")
    dequant_mix.launches += 1
    return y


# ---------------------------------------------------------------------------
# The model zoo's prefill: kernels #15 (attention), #16 (SSD), #17 (RG-LRU)
# ---------------------------------------------------------------------------

_ACTIVATION_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLASH_HEAD_DIMS = (64, 128, 256)


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (nor has the reference's "
            f"Pallas kernel); call it under torch.no_grad() or "
            f"torch.inference_mode(), and differentiate the model with "
            f"impl='xla'")


def _activation_dtype(name: str, t: torch.Tensor, *same) -> int:
    """The kernel's dtype code of ``t`` (f32 or bf16), shared by ``same``."""
    if t.dtype not in _ACTIVATION_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    for other_name, other in same:
        if other.dtype != t.dtype:
            raise TypeError(f"{other_name} must be {t.dtype} like {name}, "
                            f"got {other.dtype}")
    return _ACTIVATION_DTYPES[t.dtype]


def _aligned16(*tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernel reads 16-byte vectors: pass "
                         "tensors whose data starts on a 16-byte boundary")


def flash_attention(q, k, v, *, window: int = 0, scale=None):
    """#15 causal GQA attention, the last ``window`` keys only when
    ``window`` > 0: q (B, S, H, hd), k/v (B, S, KV, hd) with H % KV == 0
    and hd in (64, 128, 256), f32 or bf16; online softmax in f32, P kept to
    f32 accuracy for PV (bf16: on the tensor cores as P_hi·V + P_lo·V);
    output (B, S, H, hd) in q's dtype (kernel: flash_attention.cu)."""
    _forward_only("flash_attention", q, k, v)
    dtype = _activation_dtype("q", q, ("k", k), ("v", v))
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, S, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape[3] != hd or kv < 1 or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B, S, hd; H % KV == 0)")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {FLASH_HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = hd ** -0.5 if scale is None else float(scale)
    if not _on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, window=window, scale=scale)
    _aligned16(q, k, v)
    out = torch.empty_like(q)
    lib = build.load().libs["flash_attention"]
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), b, s, h, kv, hd, window,
                             ctypes.c_float(scale), dtype, _stream(q))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    return out


def ssd_scan(x, dt, a, b, c):
    """#16 the Mamba2 SSD scan from a zero state: x (B, S, H, P) and b/c
    (B, S, N) in f32 or bf16, dt (B, S, H) and a (H,) f32; y (B, S, H, P)
    in x's dtype.  The kernel runs the chunked form in three passes (the
    chunk states, the f32 recurrence over the chunks, each chunk's output),
    its decays from direct segment sums of Δ·A; bf16 on the tensor cores
    with the f32 operand of each product split into bf16 hi + lo.  One
    counted launch per call (kernel: ssd_scan.cu)."""
    _forward_only("ssd_scan", x, dt, a, b, c)
    dtype = _activation_dtype("x", x, ("b", b), ("c", c))
    if x.ndim != 4 or b.ndim != 3:
        raise ValueError(f"x must be (B, S, H, P) and b, c (B, S, N), got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _check_buffer("dt", dt, (bsz, s, h))
    _check_buffer("a", a, (h,))
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bsz, s, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bsz, s, n)}")
    if n % 8 or not 8 <= n <= 256:
        raise ValueError(f"d_state {n} must be a multiple of 8 in [8, 256]")
    if not _on_cuda(x, dt, a, b, c):
        return ref.ssd_scan_ref(x, dt, a, b, c)
    y = torch.empty_like(x)
    lib = build.load().libs["ssd_scan"]
    dims = (ctypes.c_int64 * 2)()  # chunks, scratch floats per chunk
    _raise_on(lib.ssd_scan_scratch(s, p, n, dtype, dims), "ssd_scan")
    chunks, per_chunk = dims
    states = torch.empty(bsz * h * chunks * per_chunk, dtype=torch.float32,
                         device=x.device)
    decay = torch.empty(bsz * h * chunks, dtype=torch.float32,
                        device=x.device)
    rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), y.data_ptr(), states.data_ptr(),
                      decay.data_ptr(), bsz, s, h, p, n, dtype, _stream(x))
    _raise_on(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y


def rglru_scan(a, bx):
    """#17 h_t = a_t ⊙ h_{t−1} + bx_t from h_0 = 0: a, bx (B, S, W) f32 or
    bf16, read once; returns (h (B, S, W) f32, h_last (B, W) f32, equal to
    h[:, −1]) (kernel: rglru_scan.cu)."""
    _forward_only("rglru_scan", a, bx)
    dtype = _activation_dtype("a", a, ("bx", bx))
    if a.ndim != 3 or tuple(bx.shape) != tuple(a.shape) or a.shape[1] < 1:
        raise ValueError(f"a and bx must be one (B, S, W) shape with S >= 1, "
                         f"got {tuple(a.shape)}, {tuple(bx.shape)}")
    bsz, s, w = a.shape
    if not _on_cuda(a, bx):
        return ref.rglru_scan_ref(a, bx)
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    lib = build.load().libs["rglru_scan"]
    rc = lib.rglru_scan(a.data_ptr(), bx.data_ptr(), h.data_ptr(),
                        h_last.data_ptr(), bsz, s, w, dtype, _stream(a))
    _raise_on(rc, "rglru_scan")
    rglru_scan.launches += 1
    return h, h_last


_KERNEL_WRAPPERS = (gossip_mix, gossip_mix_sparse, update_mix,
                    update_mix_sparse, gossip_mix_batched,
                    gossip_mix_sparse_batched, update_mix_batched,
                    update_mix_sparse_batched, ef_mix, ef_mix_sparse,
                    quant_mix, dequant_mix, ef_mix_batched,
                    ef_mix_sparse_batched, flash_attention, ssd_scan,
                    rglru_scan)


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
    in ascending order; padded slots point at i itself and are masked (the
    R = 1 case of core.gossip.stacked_ell_tables)."""
    from repro_torch.core import gossip as gossip_lib
    from repro_torch.core import topology
    nbr, valid, _ = gossip_lib.stacked_ell_tables(
        [topology.Graph(np.asarray(adjacency, dtype=bool))])
    return nbr[0], valid[0]


def ell_weights(w: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                dtype: torch.dtype = torch.float32):
    """Live (wv, wd) from the sampled W, (n, n) or (R, n, n), in ``dtype``
    (the kernels' f32 by default, as the reference's ``_ell_weights``):
    failed links read 0."""
    wf = w.to(dtype)
    wv = torch.where(mask, torch.gather(wf, -1, nbr.long()),
                     torch.zeros((), dtype=dtype, device=wf.device))
    return wv.contiguous(), torch.diagonal(wf, dim1=-2,
                                           dim2=-1).contiguous()


class EllTables:
    """Static ELL tables (nbr, mask), (n, max_deg) for one graph or
    (R, n, max_deg) for a lattice, moved once to each device that asks."""

    def __init__(self, nbr: np.ndarray, mask: np.ndarray):
        self.nbr, self.mask = nbr, mask
        self._on = {}

    def on(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (torch.as_tensor(self.nbr, device=device),
                                torch.as_tensor(self.mask, device=device))
        return self._on[device]

    def weights(self, w: torch.Tensor, x: torch.Tensor,
                dtype: torch.dtype = torch.float32):
        """(nbr, wv, wd) on x's device, the weights read from W in
        ``dtype``."""
        if tuple(x.shape[:-1]) != self.nbr.shape[:-1]:
            raise ValueError(f"buffer of shape {tuple(x.shape)} does not "
                             f"match the ELL table's rows "
                             f"{self.nbr.shape[:-1]}")
        nbr, mask = self.on(x.device)
        wv, wd = ell_weights(w, nbr, mask, dtype)
        return nbr, wv, wd


def make_sparse_gossip(graph):
    """mix(w, x) over the graph's static ELL table (kernel #2 on CUDA),
    reading the live edge weights from the sampled W every call."""
    tables = EllTables(*ell_table(graph.adjacency))

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return gossip_mix_sparse(*tables.weights(w, x), x)

    return mix


def make_sparse_update_mix(graph, *, beta=None, nesterov=False):
    """fused(w, x, g, eta, m=None) over the graph's ELL table (kernel #4
    on CUDA)."""
    tables = EllTables(*ell_table(graph.adjacency))

    def fused(w, x, g, eta, m=None):
        return update_mix_sparse(*tables.weights(w, x), x, g, eta, m,
                                 beta=beta, nesterov=nesterov)

    return fused


def _lattice_tables(graphs) -> EllTables:
    from repro_torch.core import gossip as gossip_lib
    nbr, valid, _ = gossip_lib.stacked_ell_tables(graphs)
    return EllTables(nbr, valid)


def make_sparse_gossip_batched(graphs):
    """mix(w, x) for w (R, n, n), x (R, n, D) over the lattice's stacked
    ELL tables (kernel #6 on CUDA, one launch for all R runs), reading each
    run's live edge weights from its sampled W every call."""
    tables = _lattice_tables(graphs)

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return gossip_mix_sparse_batched(*tables.weights(w, x), x)

    return mix


def make_sparse_update_mix_batched(graphs, *, beta=None, nesterov=False):
    """fused(w, x, g, eta, m=None) over the lattice's stacked ELL tables
    (kernel #8 on CUDA); η holds one value per run."""
    tables = _lattice_tables(graphs)

    def fused(w, x, g, eta, m=None):
        return update_mix_sparse_batched(*tables.weights(w, x), x, g, eta, m,
                                         beta=beta, nesterov=nesterov)

    return fused


def make_sparse_ef_mix(graph):
    """ef(w, p, s, u) -> (y, r) over the graph's static ELL table (kernel
    #11 on CUDA), reading the live edge weights from the sampled W."""
    tables = EllTables(*ell_table(graph.adjacency))

    def ef(w, p, s, u):
        return ef_mix_sparse(*tables.weights(w, p), p, s, u)

    return ef


def make_sparse_ef_mix_batched(graphs):
    """ef(w, p, s, u) -> (y, r) for w (R, n, n), p/s/u (R, n, D) over the
    lattice's stacked ELL tables (kernel #12 on CUDA, one launch for all R
    runs), reading each run's live edge weights from its sampled W."""
    tables = _lattice_tables(graphs)

    def ef(w, p, s, u):
        return ef_mix_sparse_batched(*tables.weights(w, p), p, s, u)

    return ef
