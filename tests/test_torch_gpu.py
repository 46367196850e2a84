"""The port's CUDA kernels (#1–#17) against their plain versions, on the
card.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(the kernels have no CPU mode).  The file imports no jax, so it runs on a
machine that has PyTorch and a card only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: max abs error ≤ 1e-5·max|y| in f32 (another summation order;
TF32 is off).  A run's slice of a batched kernel (#5–#8) equals the
single-run kernel (#1–#4) on that slice exactly, as #10/#12's slices
equal #9/#11, and so do the EF residual r of #9–#12 and the int8 payload
q of #13 their plain versions'.  The model zoo's prefill kernels (#15
flash attention, #16 the SSD scan, #17 the RG-LRU scan) are held to
1e-5·max|y| in f32 and 1e-2·max|y| in bf16 (one rounding of the bf16
output), #17's h_last to h[:, −1] exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import compress, gossip
from repro_torch.core import topology as topo
from repro_torch.kernels import ops, ref

SHAPES = [(1, 1), (5, 1000003), (8, 4099), (13, 3001), (37, 1031),
          (256, 10007)]
LATTICES = [(1, 5, 1000003), (3, 1, 777), (2, 8, 4099), (2, 13, 3001),
            (3, 37, 1031), (2, 256, 10007)]
VARIANTS = ["gossip", "sgd", "momentum", "nesterov"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ring(n: int):
    if n < 3:
        return topo.Graph(np.zeros((n, n), dtype=bool))
    return topo.ring_graph(n, k=min(2, (n - 1) // 2))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("variant", ["gossip", "sgd", "momentum",
                                     "nesterov"])
@pytest.mark.parametrize("ell", [False, True], ids=["dense", "ell"])
def test_cuda_kernel_matches_plain_version(cuda, n, d, variant, ell):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 7919 + d)
    x, g, m = (torch.randn(n, d, device=cuda, generator=gen)
               for _ in range(3))
    w = torch.rand(n, n, device=cuda, generator=gen)
    eta = torch.tensor([0.05], device=cuda)
    nbr, mask = (torch.as_tensor(a, device=cuda)
                 for a in ops.ell_table(_ring(n).adjacency))
    wv, wd = ops.ell_weights(w, nbr, mask)
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    mm = None if beta is None else m
    if variant == "gossip":
        got = (ops.gossip_mix_sparse(nbr, wv, wd, x) if ell
               else ops.gossip_mix(w, x))
        want = (ref.gossip_mix_sparse(nbr, wv, wd, x) if ell
                else ref.gossip_mix(w, x))
    elif ell:
        got = ops.update_mix_sparse(nbr, wv, wd, x, g, eta, mm, **kw)
        want = ref.update_mix_sparse(nbr, wv, wd, x, g, eta, mm, **kw)
    else:
        got = ops.update_mix(w, x, g, eta, mm, **kw)
        want = ref.update_mix(w, x, g, eta, mm, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _lattice_graphs(r: int, n: int):
    """Per-run topologies of different degrees; the last run of a
    lattice of more than one is edgeless."""
    graphs = [topo.ring_graph(n, k=1 + (i % 2)) if n >= 5 else _ring(n)
              for i in range(r)]
    if r > 1:
        graphs[-1] = topo.Graph(np.zeros((n, n), dtype=bool))
    return graphs


def _lattice_inputs(cuda, r: int, n: int, d: int):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(r * 104729 + n * 7919 + d)
    x, g, m = (torch.randn(r, n, d, device=cuda, generator=gen)
               for _ in range(3))
    w = torch.rand(r, n, n, device=cuda, generator=gen)
    eta = 0.05 * torch.arange(1, r + 1, device=cuda, dtype=torch.float32)
    graphs = _lattice_graphs(r, n)
    nbr, mask, _ = gossip.stacked_ell_tables(graphs)
    nbr, mask = torch.as_tensor(nbr, device=cuda), torch.as_tensor(
        mask, device=cuda)
    wv, wd = ops.ell_weights(w, nbr, mask)
    return dict(x=x, g=g, m=m, w=w, eta=eta, nbr=nbr, wv=wv, wd=wd,
                graphs=graphs)


def _batched_call(mod, variant, ell, t):
    """The batched kernel (``mod`` = ops) or its plain version (ref)."""
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    m = None if beta is None else t["m"]
    tab = (t["nbr"], t["wv"], t["wd"])
    if variant == "gossip":
        return (mod.gossip_mix_sparse_batched(*tab, t["x"]) if ell
                else mod.gossip_mix_batched(t["w"], t["x"]))
    if ell:
        return mod.update_mix_sparse_batched(*tab, t["x"], t["g"], t["eta"],
                                             m, **kw)
    return mod.update_mix_batched(t["w"], t["x"], t["g"], t["eta"], m, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,d", LATTICES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ell", [False, True], ids=["dense", "ell"])
def test_cuda_batched_kernel_matches_plain_version(cuda, r, n, d, variant,
                                                   ell):
    t = _lattice_inputs(cuda, r, n, d)
    got = _batched_call(ops, variant, ell, t)
    want = _batched_call(ref, variant, ell, t)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,d", [(3, 8, 4099), (2, 13, 3001),
                                   (3, 37, 1031)])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ell", [False, True], ids=["dense", "ell"])
def test_cuda_batched_slice_is_the_single_run_kernel(cuda, r, n, d, variant,
                                                     ell):
    """Run i's slice equals kernel #1–#4 on that slice (with its own,
    unpadded ELL table and its own η), to 0.0."""
    t = _lattice_inputs(cuda, r, n, d)
    got = _batched_call(ops, variant, ell, t)
    got = got if isinstance(got, tuple) else (got,)
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    for i, graph in enumerate(t["graphs"]):
        x, g, m, w, eta = (t[k][i] for k in ("x", "g", "m", "w", "eta"))
        m = None if beta is None else m
        if ell:
            tab = ops.EllTables(*ops.ell_table(graph.adjacency)).weights(w,
                                                                          x)
            one = (ops.gossip_mix_sparse(*tab, x) if variant == "gossip"
                   else ops.update_mix_sparse(*tab, x, g, eta.reshape(1), m,
                                              **kw))
        else:
            one = (ops.gossip_mix(w, x) if variant == "gossip"
                   else ops.update_mix(w, x, g, eta.reshape(1), m, **kw))
        one = one if isinstance(one, tuple) else (one,)
        for a, b in zip(got, one):
            assert (a[i] - b).abs().max().item() == 0.0


@pytest.mark.gpu
def test_cuda_launches_are_counted(cuda):
    ops.reset_launch_counts()
    x = torch.randn(4, 300, device=cuda)
    w = torch.rand(4, 4, device=cuda)
    ops.gossip_mix(w, x)
    ops.update_mix(w, x, x, torch.tensor([0.1], device=cuda))
    t = _lattice_inputs(cuda, 3, 8, 300)
    for variant in VARIANTS:
        for ell in (False, True):
            _batched_call(ops, variant, ell, t)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "gossip_mix": 1, "gossip_mix_sparse": 0, "update_mix": 1,
        "update_mix_sparse": 0, "gossip_mix_batched": 1,
        "gossip_mix_sparse_batched": 1, "update_mix_batched": 3,
        "update_mix_sparse_batched": 3, "ef_mix": 0, "ef_mix_sparse": 0,
        "quant_mix": 0, "dequant_mix": 0, "ef_mix_batched": 0,
        "ef_mix_sparse_batched": 0, "flash_attention": 0, "ssd_scan": 0,
        "rglru_scan": 0}


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn(4, 100, device=cuda, dtype=torch.float64)
    w = torch.rand(4, 4, device=cuda)
    with pytest.raises(TypeError):
        ops.gossip_mix(w, x)
    with pytest.raises(RuntimeError, match="kMaxN"):  # the kernel's limit
        ops.gossip_mix(torch.rand(401, 401, device=cuda),
                       torch.randn(401, 8, device=cuda))
    with pytest.raises(ValueError):  # a CUDA tensor beside a CPU one
        ops.gossip_mix(w.cpu(), x.float())


@pytest.mark.gpu
def test_cuda_batched_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(RuntimeError, match="kMaxN"):  # the kernel's limit
        ops.gossip_mix_batched(torch.rand(2, 401, 401, device=cuda),
                               torch.randn(2, 401, 8, device=cuda))
    t = _lattice_inputs(cuda, 2, 8, 100)
    with pytest.raises(ValueError, match="one per run"):
        ops.update_mix_batched(t["w"], t["x"], t["g"], t["eta"][:1])
    with pytest.raises(ValueError, match="one per run"):
        ops.update_mix_sparse_batched(t["nbr"], t["wv"], t["wd"], t["x"],
                                      t["g"], torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):  # a CPU W beside CUDA x
        ops.gossip_mix_batched(t["w"].cpu(), t["x"])


COMPRESS_KERNELS = ["ef_mix", "ef_mix_sparse", "quant_mix", "dequant_mix"]


def _compress_call(mod, kernel: str, t: dict):
    """Kernel #9, #11, #13 or #14 (``mod`` = ops) or its plain version
    (ref) on inputs ``t``."""
    if kernel == "ef_mix":
        return mod.ef_mix(t["w"], t["p"], t["s"], t["u"])
    if kernel == "ef_mix_sparse":
        return mod.ef_mix_sparse(t["nbr"], t["wv"], t["wd"], t["p"], t["s"],
                                 t["u"])
    if kernel == "quant_mix":
        return mod.quant_mix(t["w"], t["u"], t["noise"], t["p"], t["scale"])
    return mod.dequant_mix(t["w"], t["q"], t["scale"], t["p"])


def _compress_inputs(cuda, n: int, d: int) -> dict:
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 6007 + d)
    p, s, u = (torch.randn(n, d, device=cuda, generator=gen)
               for _ in range(3))
    u[0] *= 40.0  # rows of different int8 scales
    noise = torch.rand(n, d, device=cuda, generator=gen)
    w = torch.rand(n, n, device=cuda, generator=gen)
    nbr, mask = (torch.as_tensor(a, device=cuda)
                 for a in ops.ell_table(_ring(n).adjacency))
    wv, wd = ops.ell_weights(w, nbr, mask)
    payload = compress.parse_compress("int8").encode(noise, u)
    return dict(p=p, s=s, u=u, noise=noise, w=w, nbr=nbr, wv=wv, wd=wd,
                scale=payload["scale"], q=payload["q"])


def _assert_compress_matches(kernel: str, t: dict) -> None:
    """y within 1e-5·max|y|; the residual r (#9, #11) and the int8 payload
    q (#13) equal the plain version's exactly."""
    got = _compress_call(ops, kernel, t)
    want = _compress_call(ref, kernel, t)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    y, want_y = got[0], want[0]
    assert (y - want_y).abs().max().item() <= \
        1e-5 * want_y.abs().max().item()
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# D % 4 == 0 at n <= 8 takes the kernels' 16-byte accesses, the other
# shapes their masked scalar ones
COMPRESS_SHAPES = SHAPES + [(6, 40000), (8, 65536)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", COMPRESS_SHAPES)
@pytest.mark.parametrize("kernel", COMPRESS_KERNELS)
def test_cuda_compress_kernel_matches_plain_version(cuda, n, d, kernel):
    _assert_compress_matches(kernel, _compress_inputs(cuda, n, d))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", COMPRESS_KERNELS)
def test_cuda_compress_kernel_on_misaligned_buffers(cuda, kernel):
    """Contiguous buffers that start 4 bytes past a 16-byte boundary (D a
    multiple of 4) take the scalar accesses and agree all the same."""
    t = _compress_inputs(cuda, 8, 4096)
    for key in ("p", "s", "u", "noise"):
        buf = torch.empty(t[key].numel() + 1, device=cuda)
        t[key] = buf[1:].view_as(t[key]).copy_(t[key])
        assert t[key].is_contiguous() and t[key].data_ptr() % 16 == 4
    _assert_compress_matches(kernel, t)


@pytest.mark.gpu
def test_cuda_quant_mix_emits_the_codec_payload(cuda):
    """#13's q is the int8 codec's q, and its y is #14's on that q."""
    t = _compress_inputs(cuda, 8, 50001)
    y, q = ops.quant_mix(t["w"], t["u"], t["noise"], t["p"], t["scale"])
    assert torch.equal(q, t["q"])
    y14 = ops.dequant_mix(t["w"], q, t["scale"], t["p"])
    assert (y - y14).abs().max().item() <= 1e-5 * y14.abs().max().item()


@pytest.mark.gpu
def test_cuda_compress_launches_are_counted(cuda):
    t = _compress_inputs(cuda, 5, 777)
    ops.reset_launch_counts()
    for kernel in COMPRESS_KERNELS:
        _compress_call(ops, kernel, t)
        _compress_call(ref, kernel, t)  # plain versions do not count
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] == 1 for k in COMPRESS_KERNELS)
    assert sum(counts.values()) == len(COMPRESS_KERNELS)


@pytest.mark.gpu
def test_cuda_compress_wrappers_raise_instead_of_falling_back(cuda):
    t = _compress_inputs(cuda, 4, 100)
    with pytest.raises(TypeError):
        ops.ef_mix(t["w"], t["p"].double(), t["s"], t["u"])
    with pytest.raises(TypeError):
        ops.dequant_mix(t["w"], t["q"].int(), t["scale"], t["p"])
    with pytest.raises(ValueError):  # a CPU W beside CUDA buffers
        ops.quant_mix(t["w"].cpu(), t["u"], t["noise"], t["p"], t["scale"])
    big = torch.randn(401, 8, device=cuda)
    with pytest.raises(RuntimeError, match="kMaxN"):  # the kernel's limit
        ops.ef_mix(torch.rand(401, 401, device=cuda), big, big, big)


# ---------------------------------------------------------------------------
# The batched EF kernels #10/#12 of the compressed sweep lattice
# ---------------------------------------------------------------------------

BATCHED_EF_KERNELS = ["ef_mix_batched", "ef_mix_sparse_batched"]
# ragged D (≡ 1, 2, 3 mod 4: the masked scalar accesses), n not a multiple
# of 8, R = 1 and 3; D % 4 == 0 at n <= 8 takes the 16-byte accesses
EF_LATTICES = LATTICES + [(3, 8, 4098), (2, 5, 1002), (1, 8, 65536),
                          (3, 6, 40000)]


def _ef_lattice_inputs(cuda, r: int, n: int, d: int) -> dict:
    t = _lattice_inputs(cuda, r, n, d)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(r * 6007 + n * 31 + d)
    t["p"], t["s"], t["u"] = (torch.randn(r, n, d, device=cuda,
                                          generator=gen) for _ in range(3))
    t["u"][:, 0] *= 40.0
    return t


def _batched_ef_call(mod, kernel: str, t: dict):
    """Kernel #10 or #12 (``mod`` = ops) or its plain version (ref)."""
    if kernel == "ef_mix_batched":
        return mod.ef_mix_batched(t["w"], t["p"], t["s"], t["u"])
    return mod.ef_mix_sparse_batched(t["nbr"], t["wv"], t["wd"], t["p"],
                                     t["s"], t["u"])


def _assert_batched_ef_matches(kernel: str, t: dict) -> None:
    """y within 1e-5·max|y|, the residual r bit for bit."""
    y, r = _batched_ef_call(ops, kernel, t)
    want_y, want_r = _batched_ef_call(ref, kernel, t)
    torch.cuda.synchronize()
    assert (y - want_y).abs().max().item() <= \
        1e-5 * want_y.abs().max().item()
    assert torch.equal(r, want_r)


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,d", EF_LATTICES)
@pytest.mark.parametrize("kernel", BATCHED_EF_KERNELS)
def test_cuda_batched_ef_kernel_matches_plain_version(cuda, r, n, d,
                                                      kernel):
    _assert_batched_ef_matches(kernel, _ef_lattice_inputs(cuda, r, n, d))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", BATCHED_EF_KERNELS)
def test_cuda_batched_ef_kernel_on_misaligned_buffers(cuda, kernel):
    """Contiguous lattices that start 4 bytes past a 16-byte boundary (D a
    multiple of 4) take the scalar accesses and agree all the same."""
    t = _ef_lattice_inputs(cuda, 2, 8, 4096)
    for key in ("p", "s", "u"):
        buf = torch.empty(t[key].numel() + 1, device=cuda)
        t[key] = buf[1:].view_as(t[key]).copy_(t[key])
        assert t[key].is_contiguous() and t[key].data_ptr() % 16 == 4
    _assert_batched_ef_matches(kernel, t)


@pytest.mark.gpu
@pytest.mark.parametrize("r,n,d", [(3, 8, 4099), (2, 8, 65536),
                                   (2, 13, 3001), (3, 37, 1031)])
@pytest.mark.parametrize("kernel", BATCHED_EF_KERNELS)
def test_cuda_batched_ef_slice_is_the_single_run_kernel(cuda, r, n, d,
                                                        kernel):
    """Run i's slice of #10 equals #9 on that slice, and of #12 (the
    lattice's padded ELL tables) #11 on the run's own table, to 0.0."""
    t = _ef_lattice_inputs(cuda, r, n, d)
    got = _batched_ef_call(ops, kernel, t)
    for i, graph in enumerate(t["graphs"]):
        p, s, u, w = (t[k][i] for k in ("p", "s", "u", "w"))
        if kernel == "ef_mix_batched":
            one = ops.ef_mix(w, p, s, u)
        else:
            one = ops.make_sparse_ef_mix(graph)(w, p, s, u)
        for a, b in zip(got, one):
            assert (a[i] - b).abs().max().item() == 0.0


@pytest.mark.gpu
def test_cuda_batched_ef_launches_are_counted(cuda):
    t = _ef_lattice_inputs(cuda, 3, 8, 777)
    ops.reset_launch_counts()
    for kernel in BATCHED_EF_KERNELS:
        _batched_ef_call(ops, kernel, t)
        _batched_ef_call(ref, kernel, t)  # plain versions do not count
    ops.make_sparse_ef_mix_batched(t["graphs"])(t["w"], t["p"], t["s"],
                                                t["u"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ef_mix_batched"] == 1
    assert counts["ef_mix_sparse_batched"] == 2
    assert sum(counts.values()) == 3


@pytest.mark.gpu
def test_cuda_batched_ef_wrappers_raise_instead_of_falling_back(cuda):
    t = _ef_lattice_inputs(cuda, 2, 8, 100)
    with pytest.raises(TypeError):
        ops.ef_mix_batched(t["w"], t["p"], t["s"].double(), t["u"])
    with pytest.raises(ValueError):  # a CPU W beside CUDA buffers
        ops.ef_mix_batched(t["w"].cpu(), t["p"], t["s"], t["u"])
    with pytest.raises(ValueError):  # a strided (non-contiguous) slice
        ops.ef_mix_sparse_batched(t["nbr"], t["wv"], t["wd"],
                                  t["p"][:, :, ::2], t["s"][:, :, ::2],
                                  t["u"][:, :, ::2])
    big = torch.randn(2, 401, 8, device=cuda)
    with pytest.raises(RuntimeError, match="kMaxN"):  # the kernel's limit
        ops.ef_mix_batched(torch.rand(2, 401, 401, device=cuda), big, big,
                           big)


# ---------------------------------------------------------------------------
# The model zoo's prefill: #15 flash attention, #16 SSD scan, #17 RG-LRU scan
# ---------------------------------------------------------------------------

ZOO_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (B, S, H, KV, hd, window): S off the 64-query and 32-key tiles
FLASH_SHAPES = [(1, 1, 2, 1, 64, 0), (1, 77, 4, 2, 64, 0),
                (2, 130, 4, 1, 128, 64), (1, 200, 2, 2, 256, 64),
                (1, 97, 6, 3, 64, 64), (2, 65, 2, 2, 256, 0),
                (1, 300, 2, 1, 128, 1)]
# (B, S, H, P, N): P off the 16-row blocks, N from 8 to 256
SSD_SHAPES = [(1, 1, 1, 1, 8), (1, 100, 3, 20, 16), (2, 77, 4, 64, 128),
              (1, 50, 2, 17, 8), (1, 300, 5, 64, 256)]
# (B, S, W): W not a multiple of 4, S off the 32-step unroll
RGLRU_SHAPES = [(1, 1, 1), (2, 77, 301), (1, 33, 4097), (3, 5, 2),
                (1, 1000, 1023)]


def _zoo_close(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ZOO_TOL[dtype] * want.float().abs().max().item()


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, device=gen.device, generator=gen).to(dtype)


def _gen(cuda, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return gen


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,kv,hd,window", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain_version(cuda, b, s, h, kv, hd,
                                                    window, dtype):
    gen = _gen(cuda, s * 7 + hd + window)
    q = _randn(gen, b, s, h, hd, dtype=dtype)
    k, v = (_randn(gen, b, s, kv, hd, dtype=dtype) for _ in range(2))
    with torch.inference_mode():
        got = ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        _zoo_close(got, ref.flash_attention_ref(q, k, v, window=window),
                   dtype)


def _ssd_args(cuda, b, s, h, p, n, dtype, seed=0):
    gen = _gen(cuda, seed)
    dt = torch.nn.functional.softplus(_randn(gen, b, s, h) - 4.6)
    a = -torch.arange(1, h + 1, device=cuda, dtype=torch.float32)
    return (_randn(gen, b, s, h, p, dtype=dtype), dt, a,
            _randn(gen, b, s, n, dtype=dtype),
            _randn(gen, b, s, n, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n", SSD_SHAPES)
def test_cuda_ssd_scan_matches_plain_version(cuda, b, s, h, p, n, dtype):
    args = _ssd_args(cuda, b, s, h, p, n, dtype, seed=s + p + n)
    with torch.inference_mode():
        got = ops.ssd_scan(*args)
        torch.cuda.synchronize()
        _zoo_close(got, ref.ssd_scan_ref(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,w", RGLRU_SHAPES)
def test_cuda_rglru_scan_matches_plain_version(cuda, b, s, w, dtype):
    gen = _gen(cuda, s * w)
    a = torch.rand(b, s, w, device=cuda, generator=gen).to(dtype)
    bx = _randn(gen, b, s, w, dtype=dtype)
    with torch.inference_mode():
        h, h_last = ops.rglru_scan(a, bx)
        torch.cuda.synchronize()
        want, _ = ref.rglru_scan_ref(a, bx)
    _zoo_close(h, want, torch.float32)
    assert torch.equal(h_last, h[:, -1])


def _zoo_args(cuda, kernel, dtype=torch.float32):
    gen = _gen(cuda, 5)
    if kernel == "flash_attention":
        return [_randn(gen, 1, 70, 2, 64, dtype=dtype) for _ in range(3)]
    if kernel == "ssd_scan":
        return list(_ssd_args(cuda, 1, 70, 2, 16, 16, dtype))
    return [torch.rand(1, 70, 9, device=cuda, generator=gen).to(dtype),
            _randn(gen, 1, 70, 9, dtype=dtype)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan",
                                    "rglru_scan"])
def test_cuda_zoo_kernels_are_forward_only(cuda, kernel):
    args = _zoo_args(cuda, kernel)
    args[0].requires_grad_()
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        getattr(ops, kernel)(*args)
    with torch.no_grad():
        getattr(ops, kernel)(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan",
                                    "rglru_scan"])
def test_cuda_zoo_wrappers_raise_instead_of_falling_back(cuda, kernel):
    fn = getattr(ops, kernel)
    with pytest.raises(TypeError):
        fn(*_zoo_args(cuda, kernel, torch.float16))
    args = _zoo_args(cuda, kernel)
    with pytest.raises(ValueError):   # one input left on the CPU
        fn(*args[:-1], args[-1].cpu())
    strided = [torch.cat([t, t], dim=-1)[..., ::2] if t.ndim >= 3 else t
               for t in args]
    with pytest.raises(ValueError):   # non-contiguous views, same shapes
        fn(*strided)
