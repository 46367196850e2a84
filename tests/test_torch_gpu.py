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
output), #17's h_last to h[:, −1] exactly, #15 also at Gemma3-12B's,
Nemotron-4-15B's, Qwen2-VL-2B's and SeamlessM4T-Large-v2's prefill
shapes.  M-RoPE, cross-attention, the encoder's unmasked attention (no
kernel) and the multimodal pair's smoke forwards (#15 in each decoder
self-attention) run on the card as on the CPU, within 1e-5·max|y| (bf16
M-RoPE: one bf16 step, 2^-8·max|y|; forwards 1e-4·max|logit|).  The MoE layer and MLA (no kernel)
run on the card as on the CPU: their f32 outputs within 1e-5·max|y| of
the same call on the CPU, the routing equal.  The population engine's
cohort mix runs #2 on tables that ``build_cohort_mix`` makes (a tilted,
non-symmetric W too), held to the plain version at 1e-5·max|y|, and the
engine's overlapped and synchronous schedules end equal bit for bit on
the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import compress, gossip
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops, ref
from repro_torch.launch import specs
from repro_torch.models import attention, build_model, layers, mla, moe
from repro_torch.tree import tree_map

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


def _misaligned(t: torch.Tensor, misaligned: bool) -> torch.Tensor:
    """``t`` itself, or a contiguous copy whose data starts 4 bytes past a
    16-byte boundary."""
    if not misaligned:
        return t
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("d", [4096, 4097, 4098, 4099, 1000004])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
def test_cuda_ell_vector_rows_match_plain_version(cuda, n, d, variant,
                                                  misaligned):
    """The ELL branch at n <= 8: 16-byte accesses where D % 4 == 0 and the
    buffers are 16-byte aligned (a ragged last tile at D = 1000004), the
    masked scalar ones at D ≡ 1, 2, 3 (mod 4) and at a misaligned base."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n * 31 + d)
    x, g, m = (_misaligned(torch.randn(n, d, device=cuda, generator=gen),
                           misaligned) for _ in range(3))
    w = torch.rand(n, n, device=cuda, generator=gen)
    eta = torch.tensor([0.05], device=cuda)
    graph = topo.ring_graph(n, k=2) if n == 8 else topo.Graph(
        np.ones((n, n), dtype=bool) ^ np.eye(n, dtype=bool))
    nbr, mask = (torch.as_tensor(a, device=cuda)
                 for a in ops.ell_table(graph.adjacency))
    wv, wd = ops.ell_weights(w, nbr, mask)
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    mm = None if beta is None else m
    if variant == "gossip":
        got = ops.gossip_mix_sparse(nbr, wv, wd, x)
        want = ref.gossip_mix_sparse(nbr, wv, wd, x)
    else:
        got = ops.update_mix_sparse(nbr, wv, wd, x, g, eta, mm, **kw)
        want = ref.update_mix_sparse(nbr, wv, wd, x, g, eta, mm, **kw)
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
                                   (3, 37, 1031), (2, 8, 4096),
                                   (3, 5, 1000004)])
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
@pytest.mark.parametrize("impl", ["pallas", "sparse"])
def test_cuda_tree_mix_launches_once_per_leaf(cuda, impl):
    """The tree layout's kernel mixes (#1 for 'pallas', #2 for 'sparse')
    launch once per leaf, at narrow and ragged leaf widths, and agree
    with the same mix on the CPU."""
    rng = np.random.default_rng(0)
    tree = {"a_log": rng.standard_normal((8, 3)),
            "norm": {"scale": rng.standard_normal((8, 1))},
            "w": rng.standard_normal((8, 5, 1025))}
    w = rng.random((8, 8))
    w = w / w.sum(axis=1, keepdims=True)
    mix = ops.gossip_mix_tree if impl == "pallas" else \
        gossip.make_sparse_gossip_tree(topo.ring_graph(8, k=2))
    kernel = "gossip_mix" if impl == "pallas" else "gossip_mix_sparse"
    out = {}
    for dev in ("cpu", cuda):
        ops.reset_launch_counts()
        x = {"a_log": torch.tensor(tree["a_log"], dtype=torch.float32,
                                   device=dev),
             "norm": {"scale": torch.tensor(tree["norm"]["scale"],
                                            dtype=torch.float32,
                                            device=dev)},
             "w": torch.tensor(tree["w"], dtype=torch.float32, device=dev)}
        out[str(dev)] = mix(torch.tensor(w, dtype=torch.float32,
                                         device=dev), x)
        torch.cuda.synchronize()
        assert ops.launch_counts()[kernel] == (0 if dev == "cpu" else 3)
    from repro_torch.tree import leaves
    for got, want in zip(leaves(out[str(cuda)]), leaves(out["cpu"])):
        assert got.shape == want.shape
        assert (got.cpu() - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn(4, 100, device=cuda, dtype=torch.float16)
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
# The mix kernels (#1–#14) on float64 buffers
# ---------------------------------------------------------------------------

MIX_KERNELS = ["gossip_mix", "gossip_mix_sparse", "update_mix",
               "update_mix_sparse", "gossip_mix_batched",
               "gossip_mix_sparse_batched", "update_mix_batched",
               "update_mix_sparse_batched"] + COMPRESS_KERNELS \
    + BATCHED_EF_KERNELS
# the small path at n <= 8 (D % 4 == 0 and a ragged D), the general one
F64_SHAPES = [(5, 4099), (8, 4096), (13, 3001)]


def _f64_inputs(cuda, kernel: str, n: int, d: int) -> dict:
    """f64 buffers, an f64 W (its diagonal in f64 for #9/#10), the f32
    momentum, noise and int8 scales."""
    batched = kernel.endswith("_batched")
    if batched:
        t = _ef_lattice_inputs(cuda, 2, n, d)
    else:
        t = _compress_inputs(cuda, n, d)
        t["x"], t["g"], t["m"] = (torch.randn_like(t["p"])
                                  for _ in range(3))
        t["eta"] = torch.tensor([0.05], device=cuda)
    t["g"] = t.get("g", torch.randn_like(t["x"]))
    for k in ("x", "g", "p", "s", "u", "w"):
        t[k] = t[k].double()
    t["w"] = t["w"] + 1e-9   # not an f32 value: W is cast for the mix
    if kernel == "quant_mix":  # the scales of the f64 u, rounded to f32
        t["scale"] = (t["u"].abs().amax(-1) / 127.0).float()
    return t


def _f64_call(mod, kernel: str, t: dict, beta):
    kw = {} if beta is None else {"beta": beta, "nesterov": True}
    m = None if beta is None else t["m"]
    if kernel in COMPRESS_KERNELS:
        return _compress_call(mod, kernel, t)
    if kernel in BATCHED_EF_KERNELS:
        return _batched_ef_call(mod, kernel, t)
    ell = "sparse" in kernel
    if kernel.startswith("gossip"):
        return mod.__dict__[kernel](*((t["nbr"], t["wv"], t["wd"]) if ell
                                      else (t["w"],)), t["x"])
    return mod.__dict__[kernel](*((t["nbr"], t["wv"], t["wd"]) if ell
                                  else (t["w"],)), t["x"], t["g"],
                                t["eta"], m, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", F64_SHAPES)
@pytest.mark.parametrize("kernel", MIX_KERNELS)
def test_cuda_f64_mix_kernel_matches_plain_version(cuda, n, d, kernel):
    """An f64 buffer launches the kernel (counted): y in f64 within
    1e-5·max|y| (the f32 mix, another summation order), m' (f32), the
    residual (f64) and the int8 payload exactly."""
    t = _f64_inputs(cuda, kernel, n, d)
    for beta in ((None, 0.9) if kernel.startswith("update") else (None,)):
        ops.reset_launch_counts()
        got = _f64_call(ops, kernel, t, beta)
        assert ops.launch_counts()[kernel] == 1
        want = _f64_call(ref, kernel, t, beta)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert got[0].dtype == torch.float64
        assert (got[0] - want[0]).abs().max().item() <= \
            1e-5 * want[0].abs().max().item()
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "sparse"])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_f64_engine_launches_the_kernels(cuda, impl, fused):
    """An f64 flat engine on the card runs the mix kernels (kernel #1/#2,
    or #3/#4 fused) and agrees with the same round on the CPU."""
    from repro_torch.core import draws as draws_lib, engine
    from repro_torch.core import flat as flat_lib
    from repro_torch.core.feddec import FedDecConfig
    from repro_torch.core.mixing import MixingDistribution
    n, d = 8, 4099
    cfg = FedDecConfig(mixing=MixingDistribution(
        topo.ring_graph(n, k=2), dtype=torch.float64), gossip_impl=impl,
        h=10, k=2)   # no server round in the 2 steps: no device draws
    params1 = {"w": torch.zeros(d, dtype=torch.float64)}
    spec = flat_lib.make_flat_spec(params1)

    grad_fn = engine.value_and_grad(lambda params, batch: 0.5 * torch.sum(
        torch.square(params["w"] - batch["t"])))
    flat0 = np.random.default_rng(0).standard_normal((n, d))
    batches = {"t": np.random.default_rng(1).standard_normal((2, n, d))}
    out = {}
    for dev in ("cpu", cuda):
        state = flat_lib.flat_state_from_numpy(flat0, 1, device=dev)
        eta = torch.tensor([0.1], dtype=torch.float64, device=dev)
        round_fn = flat_lib.make_flat_feddec_round(
            cfg, spec, grad_fn, lambda t: eta, device=dev,
            fuse_update_mix=fused)
        ops.reset_launch_counts()
        state, _ = round_fn(state, {k: torch.as_tensor(v, device=dev)
                                    for k, v in batches.items()},
                            draws_lib.Draws(3, dev))
        out[str(dev)] = state.flat.cpu()
        counts = ops.launch_counts()
    kernel = {("pallas", False): "gossip_mix",
              ("sparse", False): "gossip_mix_sparse",
              ("pallas", True): "update_mix",
              ("sparse", True): "update_mix_sparse"}[impl, fused]
    assert counts[kernel] == 2 and sum(counts.values()) == 2
    want = out["cpu"]
    assert out[str(cuda)].dtype == torch.float64
    assert (out[str(cuda)] - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


# ---------------------------------------------------------------------------
# The mix kernels (#1–#14) on bfloat16 buffers
# ---------------------------------------------------------------------------

# the small path's vector rows (n 8, D % 4 == 0: 8-byte accesses of four
# bf16), its scalar ragged edge (D ≡ 3 mod 4), a ragged D at n 5 and the
# general path (n 13)
BF16_SHAPES = [(8, 4096), (8, 4099), (5, 1000003), (13, 3001)]
BF16_STEPS = {"sgd": None, "momentum": False, "nesterov": True}
# × max|y|: the f32 sums of kernel and plain version differ in order, which
# moves a bf16 rounding of y by one ulp (2^-7·max|y| at the top); the EF
# kernels (#9–#12) round the mix to bf16 before the correction, so the
# two roundings may each move an ulp
BF16_TOL = 2.0 ** -7
BF16_EF_TOL = 2.0 ** -6
# the share of y's elements that may differ at all: a kernel that rounds
# where the plain version rounds parts from it only where the two f32
# sums straddle a bf16 rounding boundary, which is rare; one that rounds
# elsewhere (x − η·g in bf16 before the mix) moves about 40% of them
BF16_Y_SHARE = 1e-3


def _bf16_cells():
    for kernel in MIX_KERNELS:
        for step in (BF16_STEPS if kernel.startswith("update") else (None,)):
            yield kernel, step


def _bf16_inputs(cuda, kernel: str, n: int, d: int,
                 misaligned: bool = False) -> dict:
    """bf16 buffers (one element past an 8-byte boundary when
    ``misaligned``), an f32 W, the f32 momentum, noise and int8 scales."""
    t = _f64_inputs(cuda, kernel, n, d)
    for k in ("x", "g", "p", "s", "u"):
        t[k] = _misaligned(t[k].to(torch.bfloat16), misaligned)
    t["w"] = t["w"].float()
    if kernel == "quant_mix":  # the scales of the bf16 u
        t["scale"] = (t["u"].float().abs().amax(-1) / 127.0)
    return t


def _bf16_call(mod, kernel: str, t: dict, step):
    """_f64_call with the momentum or nesterov step of ``step``."""
    if step in (None, "sgd"):
        return _f64_call(mod, kernel, t, None)
    if kernel.startswith("update") and not BF16_STEPS[step]:
        ell = "sparse" in kernel
        return mod.__dict__[kernel](*((t["nbr"], t["wv"], t["wd"]) if ell
                                      else (t["w"],)), t["x"], t["g"],
                                    t["eta"], t["m"], beta=0.9,
                                    nesterov=False)
    return _f64_call(mod, kernel, t, 0.9)


def _assert_bf16_matches(kernel: str, t: dict, step) -> None:
    """The bf16 kernel launches (counted once) and its y lies within
    BF16_TOL·max|y| of the plain version's (BF16_EF_TOL for #9–#12), and
    differs in at most BF16_Y_SHARE of its elements; m' (f32), the
    residual (bf16) and the int8 payload are equal."""
    ops.reset_launch_counts()
    got = _bf16_call(ops, kernel, t, step)
    assert ops.launch_counts()[kernel] == 1
    want = _bf16_call(ref, kernel, t, step)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].dtype == torch.bfloat16
    tol = BF16_EF_TOL if kernel.startswith("ef_mix") else BF16_TOL
    err = (got[0].float() - want[0].float()).abs().max().item()
    assert err <= tol * want[0].float().abs().max().item()
    share = got[0].ne(want[0]).float().mean().item()
    assert share <= BF16_Y_SHARE, share
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", BF16_SHAPES)
@pytest.mark.parametrize("kernel,step", list(_bf16_cells()), ids=[
    k if s is None else f"{k}-{s}" for k, s in _bf16_cells()])
def test_cuda_bf16_mix_kernel_matches_plain_version(cuda, n, d, kernel,
                                                    step):
    _assert_bf16_matches(kernel, _bf16_inputs(cuda, kernel, n, d), step)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,step", list(_bf16_cells()), ids=[
    k if s is None else f"{k}-{s}" for k, s in _bf16_cells()])
def test_cuda_bf16_mix_kernel_on_misaligned_buffers(cuda, kernel, step):
    """bf16 buffers one element (2 bytes) past an 8-byte boundary, D a
    multiple of 4: the masked scalar accesses, and the same results."""
    t = _bf16_inputs(cuda, kernel, 8, 4096, misaligned=True)
    assert t["x"].data_ptr() % 8 == 2
    _assert_bf16_matches(kernel, t, step)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["gossip_mix_batched",
                                    "gossip_mix_sparse_batched",
                                    "update_mix_batched",
                                    "update_mix_sparse_batched"]
                         + BATCHED_EF_KERNELS)
@pytest.mark.parametrize("n,d", [(8, 4096), (13, 3001)])
def test_cuda_bf16_batched_slice_is_the_single_run_kernel(cuda, kernel, n,
                                                          d):
    """Each run's slice of a bf16 batched kernel equals the single-run
    kernel on that slice, bit for bit (the update kernels in sgd)."""
    t = _bf16_inputs(cuda, kernel, n, d)
    got = _bf16_call(ops, kernel, t, None)
    got = got if isinstance(got, tuple) else (got,)
    single = kernel.replace("_batched", "")
    for i in range(got[0].shape[0]):
        ti = {k: v[i] if isinstance(v, torch.Tensor) and k != "eta"
              else v for k, v in t.items()}
        ti["eta"] = t["eta"][i:i + 1]
        one = _bf16_call(ops, single, ti, None)
        one = one if isinstance(one, tuple) else (one,)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)


@pytest.mark.gpu
def test_cuda_mix_kernels_refuse_float16(cuda):
    """float16 stays refused on the card, as on the CPU."""
    t = _bf16_inputs(cuda, "update_mix", 8, 4096)
    with pytest.raises(TypeError, match="bfloat16, float32 or float64"):
        ops.gossip_mix(t["w"], t["x"].half())
    with pytest.raises(TypeError):
        ops.update_mix(t["w"], t["x"].half(), t["g"].half(), t["eta"])


# ---------------------------------------------------------------------------
# The model zoo's prefill: #15 flash attention, #16 SSD scan, #17 RG-LRU scan
# ---------------------------------------------------------------------------

ZOO_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (B, S, H, KV, hd, window): S off the query and key tiles
FLASH_SHAPES = [(1, 1, 2, 1, 64, 0), (1, 77, 4, 2, 64, 0),
                (2, 130, 4, 1, 128, 64), (1, 200, 2, 2, 256, 64),
                (1, 97, 6, 3, 64, 64), (2, 65, 2, 2, 256, 0),
                (1, 300, 2, 1, 128, 1),
                # hd 128 (scale 1/sqrt(128), no power of two), S off every
                # tile, a window off the 64-key tile, KV > 1 with H / KV > 1
                (1, 300, 8, 2, 128, 100), (2, 131, 4, 4, 64, 0),
                (1, 515, 12, 3, 256, 0), (1, 1000, 16, 1, 256, 333)]
# (B, S, H, P, N): P off the 16-row blocks and the 64-row tile (17, 20,
# 80, 128), N from 8 to 256 (24 and 136 off the 16- and 64-column tiles),
# S = 1, below the 64-token chunk and off it, B 2
SSD_SHAPES = [(1, 1, 1, 1, 8), (1, 100, 3, 20, 16), (2, 77, 4, 64, 128),
              (1, 50, 2, 17, 8), (1, 300, 5, 64, 256), (1, 1, 2, 64, 128),
              (1, 40, 3, 64, 64), (2, 130, 2, 17, 8), (2, 200, 3, 128, 24),
              (1, 129, 2, 80, 136), (2, 257, 4, 20, 256)]
# (B, S, W): W not a multiple of 4 (plain loads), W % 8 == 0 (bulk
# copies), W = 1, 33, 4097, S = 1 and off the 32-token slot, B 3
RGLRU_SHAPES = [(1, 1, 1), (2, 77, 301), (1, 33, 4097), (3, 5, 2),
                (1, 1000, 1023), (1, 50, 1), (3, 1, 33), (1, 40, 4097),
                (3, 70, 4096), (2, 300, 512)]


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


def _cancelling_attention(cuda, s, h, kv, hd, seed):
    """bf16 q, k, v whose every full window cancels: v alternates in sign
    from key to key (±64, one sign pattern per KV head and dim), and the
    scores vary little (std 0.01), so y is small beside the terms p·v and
    an error in P shows at full size."""
    gen = _gen(cuda, seed)
    q = (_randn(gen, 1, s, h, hd) * 0.1).bfloat16()
    k = (_randn(gen, 1, s, kv, hd) * 0.1).bfloat16()
    sign = torch.where(torch.rand(1, 1, kv, hd, device=cuda,
                                  generator=gen) < 0.5, -1.0, 1.0)
    alt = (-1.0) ** torch.arange(s, device=cuda, dtype=torch.float32)
    return q, k, (64.0 * alt[None, :, None, None] * sign).bfloat16()


def _bf16_p_attention(q, k, v, window):
    """The one-product variant: P rounded to bf16 for P·V (what SDPA and
    the xla path compute), the row sum of the f32 P."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd).float() * hd ** -0.5
    sc = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    p = torch.exp(sc.masked_fill_(~mask, -1e30)
                  - sc.amax(-1, keepdim=True))
    y = torch.einsum("bkgst,btkh->bskgh", p.bfloat16().float(), v.float())
    return (y / p.sum(-1)[..., None].permute(0, 3, 1, 2, 4)).reshape(
        b, s, h, hd).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,hd", [(2, 1, 128), (4, 1, 256), (4, 2, 64)])
def test_cuda_flash_attention_keeps_p_to_f32_accuracy(cuda, h, kv, hd):
    """#15's bf16 kernel forms P·V as P_hi·V + P_lo·V.  On inputs whose
    windows cancel, the one-product bf16 P errs more than 1e-2·max|y| on
    the rows with a full window (checked here: the inputs can tell the
    two apart), and the kernel stays within it."""
    s, window = 384, 128
    q, k, v = _cancelling_attention(cuda, s, h, kv, hd, seed=hd)
    rows = slice(window - 1, None)
    with torch.inference_mode():
        want = ref.flash_attention_ref(q, k, v, window=window).float()
        tol = 1e-2 * want[:, rows].abs().max().item()
        one = _bf16_p_attention(q, k, v, window).float()
        assert (one - want)[:, rows].abs().max().item() > tol
        got = ops.flash_attention(q, k, v, window=window).float()
        torch.cuda.synchronize()
    assert (got - want)[:, rows].abs().max().item() <= tol


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
    assert torch.equal(h, want)  # rounded as the plain version rounds
    assert torch.equal(h_last, h[:, -1])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [512, 500])
def test_cuda_ssd_scan_keeps_the_recurrence_accuracy(cuda, s):
    """#16's f32 route where Δ·A is large (A = −77 … −80): within
    1e-6·max|y| of an f64 recurrence; its decays come from direct segment
    sums, not exp(cum_i − cum_j)."""
    args = list(_ssd_args(cuda, 1, s, 4, 64, 128, torch.float32, seed=11))
    args[2] = -torch.arange(77, 81, device=cuda, dtype=torch.float32)
    x, dt, a, b, c = (t.double() for t in args)
    with torch.inference_mode():
        state = torch.zeros(1, 4, 64, 128, dtype=torch.float64, device=cuda)
        exact = torch.empty(x.shape, dtype=torch.float64, device=cuda)
        for t in range(s):
            state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + \
                (x[:, t] * dt[:, t, :, None])[..., None] \
                * b[:, t][:, None, None, :]
            exact[:, t] = torch.einsum("bhpn,bn->bhp", state, c[:, t])
        got = ops.ssd_scan(*args)
        torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    assert err <= 1e-6 * exact.abs().max().item()


def _zoo_args(cuda, kernel, dtype=torch.float32):
    gen = _gen(cuda, 5)
    if kernel == "flash_attention":
        return [_randn(gen, 1, 70, 2, 64, dtype=dtype) for _ in range(3)]
    if kernel == "ssd_scan":
        return list(_ssd_args(cuda, 1, 70, 2, 16, 16, dtype))
    return [torch.rand(1, 70, 9, device=cuda, generator=gen).to(dtype),
            _randn(gen, 1, 70, 9, dtype=dtype)]


# (B, S, H, KV, hd, window): Gemma3-12B's local and global layers,
# Nemotron-4-15B's, Qwen2-VL-2B's (GQA 6:1) and SeamlessM4T-Large-v2's
# decoder self-attention (hd 64), at their prefill's full shapes, bf16
NEW_MODEL_FLASH = [(1, 4096, 16, 8, 256, 1024), (1, 4096, 16, 8, 256, 0),
                   (1, 4096, 48, 8, 128, 0), (1, 4096, 12, 2, 128, 0),
                   (1, 4096, 16, 16, 64, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,window", NEW_MODEL_FLASH)
def test_cuda_flash_attention_at_the_new_models_shapes(cuda, b, s, h, kv,
                                                       hd, window):
    gen = _gen(cuda, h + hd + window)
    q = _randn(gen, b, s, h, hd, dtype=torch.bfloat16)
    k, v = (_randn(gen, b, s, kv, hd, dtype=torch.bfloat16)
            for _ in range(2))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        _zoo_close(got, ref.flash_attention_ref(q, k, v, window=window),
                   torch.bfloat16)


def _distinct_mrope(gen, b, s):
    """(3, B, S) M-RoPE ids on the CPU: the sequence position, then two
    drawn components."""
    t = torch.arange(s).expand(1, b, s)
    return torch.cat([t, torch.randint(0, s, (2, b, s), generator=gen)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_apply_mrope_matches_the_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 33, 3, 128, generator=gen).to(dtype)
    pos = _distinct_mrope(gen, 2, 33) * 31
    want = layers.apply_mrope(x, pos, 1e6)
    got = layers.apply_mrope(x.to(cuda), pos.to(cuda), 1e6).cpu()
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (1e-5 if dtype == torch.float32 else 2.0 ** -8) * \
        want.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cross", "unmasked"])
def test_cuda_cross_and_unmasked_attention_match_the_cpu(cuda, case):
    """No kernel: impl='pallas' takes the plain path for both."""
    gen = torch.Generator().manual_seed(4)
    params = attention.init_attention(Draws(0, "cpu"), 128, 4, 2, 64,
                                      torch.float32, bias=True)
    x = torch.randn(2, 40, 128, generator=gen)
    pos = torch.arange(40).expand(2, 40)
    kw = dict(head_dim=64, causal=False, impl="pallas")
    if case == "cross":
        kw.update(rope_kind="none",
                  kv_override=torch.randn(2, 70, 128, generator=gen))
    want, _ = attention.attention(params, x, pos, **kw)
    if case == "cross":
        kw["kv_override"] = kw["kv_override"].to(cuda)
    ops.reset_launch_counts()
    got, _ = attention.attention(tree_map(lambda t: t.to(cuda), params),
                                 x.to(cuda), pos.to(cuda), **kw)
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0
    _zoo_close(got.cpu(), want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_cuda_multimodal_smoke_forward_matches_the_cpu(cuda, name):
    """The smoke config's impl='pallas' forward on the card (#15 once per
    decoder self-attention layer; the encoder and the cross-attention
    launch nothing) against the xla forward on the CPU, with three
    distinct M-RoPE components, the patch prefix and 24 encoder frames."""
    cfg = get_config(name).smoke()
    model = build_model(cfg)
    params = model.init(Draws(0, "cpu"))
    batch = specs.concrete_batch(cfg, None, 2, 64, Draws(1, "cpu"),
                                 enc_len=24)
    if "mrope_positions" in batch:
        batch["mrope_positions"] = _distinct_mrope(
            torch.Generator().manual_seed(5), 2, 64)
    with torch.inference_mode():
        want = model.logits(params, batch)
        ops.reset_launch_counts()
        got = model.logits(tree_map(lambda t: t.to(cuda), params),
                           {k: v.to(cuda) for k, v in batch.items()},
                           impl="pallas")
        torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == \
        {"flash_attention": cfg.num_layers}
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()


def _moe_mla_params(kind, device):
    """DeepSeek-V2-Lite's smoke MoE or MLA weights (q_lora_rank 32), f32,
    from Draws(0) on ``device``."""
    cfg = get_config("deepseek-v2-lite-16b").smoke()
    draws = Draws(0, "cpu")
    if kind == "moe":
        params = moe.init_moe(draws, cfg.d_model, cfg.moe, torch.float32)
        sub = cfg.moe
    else:
        sub = dataclasses.replace(cfg.mla, q_lora_rank=32)
        params = mla.init_mla(draws, cfg.d_model, cfg.num_heads, sub,
                              torch.float32)
    return tree_map(lambda t: t.to(device), params), sub, cfg.d_model


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [None, 2])
def test_cuda_moe_layer_matches_the_cpu(cuda, capacity):
    params, cfg, d = _moe_mla_params("moe", "cpu")
    cparams, _, _ = _moe_mla_params("moe", cuda)
    x = torch.randn(2, 24, d, generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_layer(params, x, cfg,
                                   compute_dtype=torch.float32,
                                   capacity=capacity)
    _, want_e, _ = moe._route(params["router"], x.reshape(-1, d), cfg.top_k)
    got, aux = moe.moe_layer(cparams, x.to(cuda), cfg,
                             compute_dtype=torch.float32, capacity=capacity)
    _, got_e, _ = moe._route(cparams["router"], x.to(cuda).reshape(-1, d),
                             cfg.top_k)
    assert torch.equal(got_e.cpu(), want_e)
    _zoo_close(got.cpu(), want, torch.float32)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    with torch.inference_mode():   # bf16 runs and stays finite
        y, _ = moe.moe_layer(cparams, x.to(cuda), cfg,
                             compute_dtype=torch.bfloat16)
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 5])
def test_cuda_mla_attention_matches_the_cpu(cuda, window):
    """The prefill and 6 absorbed decode steps on the card against the
    same calls on the CPU."""
    params, cfg, d = _moe_mla_params("mla", "cpu")
    cparams, _, _ = _moe_mla_params("mla", cuda)
    x = torch.randn(2, 12, d, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(12).expand(2, 12)
    want, _ = mla.mla_attention(params, x, pos, cfg=cfg, window=window,
                                compute_dtype=torch.float32)
    got, _ = mla.mla_attention(cparams, x.to(cuda), pos.to(cuda), cfg=cfg,
                               window=window, compute_dtype=torch.float32)
    _zoo_close(got.cpu(), want, torch.float32)
    cache = mla.init_mla_cache(2, 4, cfg, torch.float32, device="cpu")
    ccache = mla.init_mla_cache(2, 4, cfg, torch.float32, device=cuda)
    for t in range(6):
        want, cache = mla.mla_attention(
            params, x[:, t:t + 1], pos[:, t:t + 1], cfg=cfg, window=window,
            cache=cache, compute_dtype=torch.float32)
        got, ccache = mla.mla_attention(
            cparams, x[:, t:t + 1].to(cuda), pos[:, t:t + 1].to(cuda),
            cfg=cfg, window=window, cache=ccache,
            compute_dtype=torch.float32)
        _zoo_close(got.cpu(), want, torch.float32)
        assert torch.equal(ccache["positions"].cpu(), cache["positions"])


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


def _per_row_grads(spec, loss_fn, flat, batch):
    """The per-row ``torch.autograd.grad`` loop from Python that the
    engines ran before their one batched call: the yardstick."""
    from repro_torch.tree import build_tree
    g_flat = torch.empty_like(flat)
    losses = []
    for i in range(flat.shape[0]):
        leaves = [v.detach().requires_grad_() for v in spec.views(flat[i])]
        params = build_tree(spec.paths, leaves)
        with torch.enable_grad():
            loss = loss_fn(params, {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
        for view, gr in zip(spec.views(g_flat[i]), grads):
            view.copy_(gr)
        losses.append(loss.detach())
    return torch.stack(losses), g_flat


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [(1,), (8,), (2, 3)],
                         ids=["one", "flat", "lattice"])
def test_cuda_batched_grads_match_the_per_row_loop(cuda, lead):
    """Line 4 as one vmapped call over the (rows, D) buffer (the flat
    engine's n rows, the lattice's R·n) on the card, against the per-row
    loop: losses and g within 1e-5·max (f32, other summation order)."""
    from repro_torch.core import flat as flat_lib, sweep
    from repro_torch.core.draws import Draws
    from repro_torch.launch import train
    from repro_torch.models import build_model
    model = build_model(train.tiny_lm_config(128, 2, vocab=512))
    params = model.init(Draws(0, cuda))
    spec = flat_lib.make_flat_spec(params)
    gen = _gen(cuda, len(lead))
    flat = spec.ravel(params) + 0.02 * torch.randn(
        lead + (spec.d,), device=cuda, generator=gen)
    tokens = torch.randint(0, 512, lead + (2, 64), device=cuda,
                           generator=gen)
    batch = {"tokens": tokens,
             "positions": torch.arange(64, device=cuda).expand_as(tokens)}
    if len(lead) == 1:
        losses, g = flat_lib.grads_of(spec, model.grad_fn(), flat, batch)
    else:
        losses, g = sweep.grads_of_lattice(spec, model.grad_fn(), flat,
                                           batch)
    rows = int(np.prod(lead))
    want_l, want_g = _per_row_grads(
        spec, model.loss, flat.view(rows, spec.d),
        {k: v.reshape((rows,) + v.shape[len(lead):])
         for k, v in batch.items()})
    torch.cuda.synchronize()
    assert g.shape == lead + (spec.d,)
    scale = want_g.abs().max().item()
    assert (g.view(rows, -1) - want_g).abs().max().item() <= 1e-5 * scale
    assert (losses.view(-1) - want_l).abs().max().item() <= \
        1e-5 * want_l.abs().max().item()


DELTA_CELLS = [("full", "pallas", False, "gossip_mix"),
               ("full", "sparse", False, "gossip_mix_sparse"),
               ("topk:512", "pallas", True, "ef_mix"),
               ("lowrank:2", "sparse", True, "ef_mix_sparse")]


@pytest.mark.gpu
@pytest.mark.parametrize("delta,impl,fused,kernel", DELTA_CELLS,
                         ids=[c[0] + "-" + c[1] for c in DELTA_CELLS])
def test_cuda_delta_round_launches_its_kernel_once_a_step(cuda, delta, impl,
                                                          fused, kernel):
    """A flat round under ``delta`` (the base row the start row, 8 agents
    on ring2, H = 3 steps, the server off so that no draw differs between
    the devices) launches its mix kernel once a step on the card and no
    other, and ends within 1e-5·max|x| of the same round on the CPU
    (targets in base + a rank-2 span, so the low-rank truncation is well
    posed).  Under 'full' the card's run also ends on its delta='none'
    run's buffer exactly, with an all-zero residual."""
    from repro_torch.core import engine, feddec, flat as flat_lib
    from repro_torch.core.draws import Draws
    from repro_torch.core.mixing import MixingDistribution
    n, d, h = 8, 4096, 3
    rng = np.random.default_rng(1)
    row0 = rng.standard_normal(d).astype(np.float32)
    mats = np.stack([np.outer(rng.standard_normal(64),
                              rng.standard_normal(64)).reshape(-1)
                     for _ in range(2)])
    t = (row0 + rng.standard_normal((h, n, 2)) @ mats).astype(np.float32)
    grad_fn = engine.value_and_grad(lambda p, b: 0.5 * torch.sum(
        torch.square(p["x"] - b["t"])))
    spec = flat_lib.make_flat_spec({"x": torch.zeros(d)})

    def run(dev, spec_str):
        cfg = feddec.FedDecConfig(
            mixing=MixingDistribution(topo.ring_graph(n, k=2),
                                      scheme="metropolis"),
            h=h, k=2, server_enabled=False, gossip_impl=impl,
            delta=spec_str)
        base = torch.tensor(row0, device=dev)
        state = flat_lib.init_flat_state(spec, {"x": base}, n,
                                         delta=spec_str)
        eta = torch.tensor([0.1], device=dev)
        round_fn = flat_lib.make_flat_feddec_round(
            cfg, spec, grad_fn, lambda t: eta, device=dev,
            fuse_update_mix=fused,
            delta_base=None if spec_str == "none" else base)
        ops.reset_launch_counts()
        state, _ = round_fn(state, {"t": torch.tensor(t, device=dev)},
                            Draws(0, dev))
        torch.cuda.synchronize()
        return state, ops.launch_counts()

    got, counts = run(cuda, delta)
    assert counts[kernel] == h and sum(counts.values()) == h
    want, cpu_counts = run("cpu", delta)
    assert sum(cpu_counts.values()) == 0
    scale = want.flat.abs().max().item()
    assert (got.flat.cpu() - want.flat).abs().max().item() <= 1e-5 * scale
    assert (got.residual.cpu() - want.residual).abs().max().item() <= \
        1e-5 * scale
    if delta == "full":
        none, _ = run(cuda, "none")
        assert torch.equal(got.flat, none.flat)
        assert not got.residual.any()


# ---------------------------------------------------------------------------
# The population engine's cohort mix (kernel #2 on per-round tables)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("staleness", [0.0, 0.5])
@pytest.mark.parametrize("c,d", [(8, 4099), (64, 1000003), (256, 25)])
def test_cuda_cohort_mix_matches_plain_version(cuda, staleness, c, d):
    """``population.cohort_gossip`` on tables that ``build_cohort_mix``
    makes for a sampled cohort of a ring2 population (padded ELL of width
    5 > the subgraph's degree; with staleness > 0 a tilted, row-stochastic
    but not symmetric W) launches #2 once and agrees with the plain
    version on the same tables to 1e-5·max|y|."""
    from repro_torch.core import population as pop
    n_total = 4 * c
    spec = pop.PopulationSpec(n_total, c, staleness=staleness, max_degree=5,
                              n_clusters=2)
    rng = np.random.default_rng(c)
    last = rng.integers(-1, 6, n_total)
    ids = pop.sample_cohort(rng, spec, last, 6)
    ages = np.maximum(6 - last[ids], 0)
    graph = topo.ring_graph_csr(n_total, 2)
    mix = pop.build_cohort_mix(graph, ids, spec, ages=ages, device=cuda)
    mix_cpu = pop.build_cohort_mix(graph, ids, spec, ages=ages)
    if staleness:
        w = np.zeros((c, c))
        w[np.arange(c)[:, None], mix_cpu.nbr.numpy()] += mix_cpu.wv.numpy()
        w[np.arange(c), np.arange(c)] += mix_cpu.diag.numpy()
        assert not np.allclose(w, w.T)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d)
    x = torch.randn(c, d, device=cuda, generator=gen)
    ops.reset_launch_counts()
    got = pop.cohort_gossip(mix, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gossip_mix_sparse"] == 1
    want = ref.gossip_mix_sparse(*(t.to(cuda) for t in (
        mix_cpu.nbr, mix_cpu.wv, mix_cpu.diag)), x)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_cuda_population_engine_overlap_equals_sync(cuda):
    """The engine on the card (two-tier server, 4 rounds of H = 3 over
    cohorts of 8 from 64): the overlapped and the synchronous schedule
    launch #2 once a step and no other kernel, and end on the same store
    and losses bit for bit."""
    from repro_torch.core import engine, flat as flat_lib
    from repro_torch.core import population as pop
    from repro_torch.core.draws import Draws
    n_total, c, d, h, rounds = 64, 8, 4096, 3, 4
    rng = np.random.default_rng(3)
    targets = rng.standard_normal((rounds, h, c, d)).astype(np.float32)
    grad_fn = engine.value_and_grad(lambda p, b: 0.5 * torch.sum(
        torch.square(p["x"] - b["t"])))
    spec = flat_lib.make_flat_spec({"x": torch.zeros(d)})

    def run(dev, overlap):
        eta = torch.tensor([0.1], device=dev)
        eng = pop.PopulationEngine(
            pop.PopulationSpec(n_total, c, max_degree=4, n_clusters=2,
                               seed=1),
            spec, grad_fn, lambda t: eta, topo.ring_graph_csr(n_total, 2),
            h=h, k=2, device=dev, row_init=np.zeros(d, np.float32))
        ops.reset_launch_counts()
        out = eng.run(rounds, lambda r, ids: {
            "t": torch.tensor(targets[r], device=dev)}, Draws(0, dev),
            overlap=overlap)
        return eng.store.gather(np.arange(n_total)), out, \
            ops.launch_counts()

    rows, out, counts = run(cuda, True)
    assert counts["gossip_mix_sparse"] == rounds * h
    assert sum(counts.values()) == rounds * h
    rows_sync, out_sync, _ = run(cuda, False)
    np.testing.assert_array_equal(rows, rows_sync)
    assert out["drains"] == out_sync["drains"]
    np.testing.assert_array_equal(out["loss"], out_sync["loss"])
    assert np.isfinite(rows).all() and np.abs(rows).max() > 0


# the sharded engine's own blocks (core/sharded.py): shard 1's strided
# view W[..., nl:2nl, nl:2nl] of an (8, 8) W, n_local 1, 2 and 4
@pytest.mark.gpu
@pytest.mark.parametrize("n_local", [1, 2, 4])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("d", [4099, 100003])
def test_cuda_shard_block_mix_matches_plain_version(cuda, n_local, r, d):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n_local * 31 + r * 7 + d)
    w = torch.rand((r, 8, 8), device=cuda, generator=gen)
    blk = w[:, n_local:2 * n_local, n_local:2 * n_local]
    x = torch.randn((r, n_local, d), device=cuda, generator=gen)
    if r == 1:
        blk, x = blk[0], x[0]
    assert n_local == 1 or not blk.is_contiguous()
    fn = ops.gossip_mix if r == 1 else ops.gossip_mix_batched
    plain = ref.gossip_mix if r == 1 else ref.gossip_mix_batched
    before = fn.launches
    got = fn(blk, x)
    assert fn.launches == before + 1
    want = plain(blk, x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# the 2-D engine's column blocks (core/sharded.py): x is a rank's (n_local,
# D/M) block, its own storage, D/M odd (no multiple of 4: the kernel's
# ragged columns); W the whole (8, 8) W at one agent shard or the own
# block of agent shard 1, a strided view
@pytest.mark.gpu
@pytest.mark.parametrize("n_local", [8, 4, 2])
@pytest.mark.parametrize("d,m", [(2 * 4099, 2), (4 * 1031, 4),
                                 (2 * 100003, 2)])
def test_cuda_column_block_mix_matches_plain_version(cuda, n_local, d, m):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n_local * 131 + d + m)
    w = torch.rand((8, 8), device=cuda, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    lo = 0 if n_local == 8 else n_local
    blk = w[lo:lo + n_local, lo:lo + n_local]
    rows = torch.randn((n_local, d), device=cuda, generator=gen)
    dl = d // m
    x = rows[:, (m - 1) * dl:m * dl].contiguous()
    assert dl % 4 and x.shape == (n_local, dl)
    assert n_local == 8 or not blk.is_contiguous()
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(blk, x)
    assert ops.gossip_mix.launches == before + 1
    want = ref.gossip_mix(blk, x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _quadratic_loss(params, batch):
    return 0.5 * torch.sum(torch.square(params["z"] - batch["t"]))


@pytest.mark.gpu
@pytest.mark.parametrize("impl,sweep", [("dense", False), ("pallas", False),
                                        ("pallas", True)])
def test_cuda_sharded_world_of_one_equals_flat(cuda, tmp_path, impl, sweep):
    """A world of one rank over NCCL: the sharded round (core/sharded.py)
    on a quadratic, 8 agents, D 4099, two rounds of H 3, against the flat
    engine (the R = 2 lattice) on the same draws, within 1e-5·max|x|;
    under 'pallas' #1 (#5) once a step and nothing else."""
    import torch.distributed as dist

    from repro_torch.core import engine, flat as flat_lib, sharded
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.core.draws import SweepDraws
    from repro_torch.core.feddec import FedDecConfig
    from repro_torch.core.mixing import MixingDistribution
    from repro_torch.launch.mesh import make_agent_mesh
    n, d, h = 8, 4099, 3
    cfgs = [FedDecConfig(mixing=MixingDistribution(
        topo.ring_graph(n, 2), p_fail=0.3, scheme="metropolis"),
        h=h * (1 + r), k=2, gossip_impl=impl) for r in range(2)]
    spec = flat_lib.make_flat_spec({"z": torch.zeros(d)})
    gfn = engine.value_and_grad(_quadratic_loss)
    eta = torch.tensor([0.1], device=cuda)
    gen = torch.Generator().manual_seed(5)
    lead = (2, n) if sweep else (n,)
    x0 = torch.randn(lead + (d,), generator=gen).to(cuda)
    batches = [{"t": torch.randn((h,) + lead + (d,), generator=gen).to(cuda)}
               for _ in range(2)]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_agent_mesh(1, device="cuda")
        ends = []
        for use_mesh in (False, True):
            if sweep:
                plan = sweep_lib.make_sweep_plan(cfgs)
                state = sweep_lib.SweepFedState(flat=x0.clone(),
                                                step=np.ones(2, np.int64))
                draws = SweepDraws(3, cuda, 2, per_run=True)
                round_fn = engine.make_sharded_sweep_round(
                    plan, spec, gfn, lambda t: eta, mesh, device=cuda) \
                    if use_mesh else sweep_lib.make_sweep_feddec_round(
                        plan, spec, gfn, lambda t: eta, device=cuda)
            else:
                state = flat_lib.FlatFedState(flat=x0.clone(), step=1)
                draws = Draws(3, cuda)
                round_fn = sharded.make_sharded_feddec_round(
                    cfgs[0], spec, gfn, lambda t: eta, mesh, device=cuda) \
                    if use_mesh else flat_lib.make_flat_feddec_round(
                        cfgs[0], spec, gfn, lambda t: eta, device=cuda)
            ops.reset_launch_counts()
            for b in batches:
                state, _ = round_fn(state, b, draws)
            counts = ops.launch_counts()
            launched = sum(counts.values())
            if impl == "dense":
                assert launched == 0
            else:
                kernel = "gossip_mix_batched" if sweep else "gossip_mix"
                assert counts[kernel] == launched == 2 * h
            ends.append(state.flat)
    finally:
        dist.destroy_process_group()
    scale = ends[0].abs().max().item()
    assert (ends[1] - ends[0]).abs().max().item() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# The kernels' custom ops, and the dry run against the card (launch/steps.py)
# ---------------------------------------------------------------------------


def _op_args(cuda, name: str) -> tuple:
    """Small valid arguments of the op ``repro_torch::name``, as its
    wrapper passes them (W and ELL weights f32, η an (R,) tensor)."""
    gen = _gen(cuda, 7)
    r = 2 if name.endswith("_batched") else None
    lead = (r,) if r else ()
    n, d, deg = 6, 1030, 2
    x, g, s, u = (_randn(gen, *lead, n, d) for _ in range(4))
    w = torch.rand(*lead, n, n, device=cuda, generator=gen)
    nbr = torch.remainder(torch.arange(n, device=cuda)[:, None]
                          + torch.tensor([1, n - 1], device=cuda),
                          n).to(torch.int32).expand(*lead, n, deg)
    nbr = nbr.contiguous()
    wv = torch.rand(*lead, n, deg, device=cuda, generator=gen)
    wd = torch.rand(*lead, n, device=cuda, generator=gen)
    eta = torch.full((r or 1,), 0.05, device=cuda)
    m = _randn(gen, *lead, n, d)
    if name in ("gossip_mix", "gossip_mix_batched"):
        return w, x
    if name in ("gossip_mix_sparse", "gossip_mix_sparse_batched"):
        return nbr, wv, wd, x
    if name in ("update_mix", "update_mix_batched"):
        return w, x, g, eta, m, 0.9, False
    if name in ("update_mix_sparse", "update_mix_sparse_batched"):
        return nbr, wv, wd, x, g, eta, None, 0.0, False
    if name in ("ef_mix", "ef_mix_batched"):
        diag = torch.diagonal(w, dim1=-2, dim2=-1).contiguous()
        return w, diag, x, s, u
    if name in ("ef_mix_sparse", "ef_mix_sparse_batched"):
        return nbr, wv, wd, x, s, u
    scale = torch.rand(n, device=cuda, generator=gen) + 0.5
    if name == "quant_mix":
        return w, u, torch.rand(n, d, device=cuda, generator=gen), x, scale
    if name == "dequant_mix":
        q = torch.randint(-127, 128, (n, d), device=cuda, generator=gen,
                          dtype=torch.int8)
        return w, q, scale, x
    if name == "flash_attention":
        q = _randn(gen, 1, 130, 4, 64, dtype=torch.bfloat16)
        k = _randn(gen, 1, 130, 2, 64, dtype=torch.bfloat16)
        return q, k, torch.randn_like(k), 0, 0.125
    if name == "ssd_scan":
        b, s_, h, p, nn = 1, 100, 3, 16, 16
        return (_randn(gen, b, s_, h, p), torch.rand(b, s_, h, device=cuda),
                -torch.rand(h, device=cuda) - 0.5, _randn(gen, b, s_, nn),
                _randn(gen, b, s_, nn))
    assert name == "rglru_scan", name
    return (torch.rand(2, 33, 300, device=cuda) * 0.9,
            _randn(gen, 2, 33, 300))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ops._OPS))
def test_cuda_kernel_op_passes_opcheck(cuda, name):
    """Each kernel's custom op: its schema, its (absent) autograd
    registration and its fake against the CUDA implementation
    (torch.library.opcheck), and the fake's shapes and dtypes equal the
    real outputs'."""
    op = getattr(torch.ops.repro_torch, name).default
    args = _op_args(cuda, name)
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))
    real = op(*args)
    meta = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args))
    for got, want in zip(*(o if isinstance(o, tuple) else (o,)
                           for o in (meta, real))):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


def _dryrun_lowerable(program: str):
    """Phase 8's three programs at a small size: the tiny LM's flat
    trainer (d 256, 2 layers, 4 agents) under pallas fused momentum (#3)
    and under pallas sgd with bf16 weights (#1), and Qwen1.5-4B's smoke
    prefill under impl='pallas' (#15)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import steps, train
    from repro_torch.sharding import MeshAxes
    if program == "prefill":
        cfg = get_config("qwen1.5-4b").smoke()
        return steps.build_prefill_lowerable(
            cfg, ShapeConfig("p", 256, 2, "prefill"),
            MeshAxes(("data",), "model", {"data": 1, "model": 1}),
            impl="pallas"), "flash_attention", cfg.num_layers
    cfg = train.tiny_lm_config(d_model=256, layers=2)
    fuse, opt, kernel = (True, "momentum", "update_mix") \
        if program == "fused" else (False, "sgd", "gossip_mix")
    if program == "bf16":
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    return steps.build_train_lowerable(
        cfg, ShapeConfig("t", 64, 8, "train"),
        MeshAxes(("data",), "model", {"data": 4, "model": 1}),
        fed=FedConfig(n_agents=4, h=10, k=2, gossip_impl="pallas"),
        state_layout="flat", fuse_update_mix=fuse, optimizer=opt,
        microbatches=1), kernel, 1


@pytest.mark.gpu
@pytest.mark.parametrize("program", ["fused", "bf16", "prefill"])
def test_cuda_dryrun_matches_the_card(cuda, program):
    """The fake trace's FLOPs, op count and kernel ops equal the same
    tally of one call on the card, whose wrappers launch those kernels,
    and its peak above the arguments is within 10% of the card's."""
    import gc
    from repro_torch.launch.trace_analysis import tally
    low, kernel, count = _dryrun_lowerable(program)
    fake = low.lower().costs
    torch.mm(torch.ones(64, 64, device=cuda), torch.ones(64, 64,
                                                         device=cuda))
    fn = low.make_fn(cuda)
    args = low.make_args(cuda, 0)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    _, real = tally(fn, *args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    assert (real.ops, real.flops) == (fake.ops, fake.flops)
    assert fake.launches == launches == real.launches == {kernel: count}
    assert abs(fake.temp_bytes - measured) <= 0.10 * measured


# the tensor-parallel tree engine's leaf blocks (core/sharded.py,
# make_sharded_tree_step): each leaf's (n/A, numel/M_leaf) block mixed by
# #1 under 'pallas' and by #2 under 'sparse' at one agent shard, with a
# ragged D (no multiple of 4) and W of 2 agents on a ring
@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["gossip_mix", "gossip_mix_sparse"])
@pytest.mark.parametrize("d", [2_560, 151_936 // 2 * 8, 4_097])
def test_cuda_tp_leaf_block_mix_matches_plain_version(cuda, kernel, d):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + len(kernel))
    w = torch.rand((2, 2), device=cuda, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    x = torch.randn((2, d), device=cuda, generator=gen)
    if kernel == "gossip_mix":
        fn, args, plain = ops.gossip_mix, (w, x), ref.gossip_mix
    else:
        nbr, mask = (torch.as_tensor(a, device=cuda) for a in ops.ell_table(
            [[False, True], [True, False]]))
        fn, plain = ops.gossip_mix_sparse, ref.gossip_mix_sparse
        args = (nbr, *ops.ell_weights(w, nbr, mask), x)
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    want = plain(*args)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _tp_world_rank(rank, world, store, out_path, impl,
                   arch="qwen1.5-4b"):
    """A rank of test_cuda_tp_tree_step_equals_one_device's gloo world on
    the one card: ``arch``'s smoke config (f32), 2 agents on a (1, 2)
    mesh, two tree steps, its blocks gathered."""
    import pickle

    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.core import sharded
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.sharding import tp
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = mesh_lib.make_fed_mesh(1, world, device="cuda")
        cfg, fcfg, state, batches = _tp_setup(impl, arch)
        tcfg = steps.adapt_for_mesh(cfg, tp.mesh_axes(mesh))
        specs = shd.param_pspecs(tcfg, state.params, tp.mesh_axes(mesh))
        blk = sharded.shard_tree_state(state, specs, mesh)
        step = sharded.make_sharded_tree_step(
            fcfg, build_model(tcfg).grad_fn(), lambda t: 1e-2, mesh,
            device="cuda", param_specs=specs)
        draws = Draws(4, "cuda")
        ops.reset_launch_counts()
        for batch in batches:
            blk, _ = step(blk, batch, draws)
        counts = ops.launch_counts()
        whole = sharded.gather_tree_state(blk, specs, mesh)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump({"params": tree_map(lambda t: t.cpu(),
                                                whole.params),
                             "counts": counts}, f)
    finally:
        dist.destroy_process_group()


def _tp_setup(impl: str, arch: str = "qwen1.5-4b"):
    from repro_torch.core import feddec
    from repro_torch.core.mixing import MixingDistribution
    cfg = get_config(arch).smoke()
    if cfg.moe is not None:
        # a dense first layer, then two MoE groups
        cfg = dataclasses.replace(cfg, num_layers=3)
    fcfg = feddec.FedDecConfig(mixing=MixingDistribution(
        topo.ring_graph(2, k=1)), h=2, k=2, gossip_impl=impl)
    state = feddec.init_state(build_model(cfg).init(Draws(3, "cuda")), 2)
    gen = torch.Generator().manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 1, 16),
                                        generator=gen).cuda(),
                "positions": torch.arange(16).expand(2, 1, 16).cuda()}
               for _ in range(2)]
    return cfg, fcfg, state, batches


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "sparse"])
def test_cuda_tp_tree_step_equals_one_device(cuda, tmp_path, impl):
    """Two steps of the tensor-parallel tree engine in a gloo world of 2
    ranks on the one card (Qwen1.5-4B smoke, 2 agents, (1, 2)) against
    the tree engine on one device: the gathered state within
    1e-5·max|x|; #1 (#2 under 'sparse') once per leaf block a step on
    each rank."""
    import pickle

    import torch.multiprocessing as mp
    from repro_torch.core import feddec
    from repro_torch.tree import leaves
    out_path = tmp_path / "out.pkl"
    mp.start_processes(_tp_world_rank, args=(2, str(tmp_path / "store"),
                                             str(out_path), impl),
                       nprocs=2, start_method="spawn", join=True)
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    cfg, fcfg, state, batches = _tp_setup(impl)
    step = feddec.make_feddec_step(fcfg, build_model(cfg).grad_fn(),
                                   lambda t: 1e-2, device="cuda")
    draws = Draws(4, "cuda")
    for batch in batches:
        state, _ = step(state, batch, draws)
    kernel = {"pallas": "gossip_mix", "sparse": "gossip_mix_sparse"}[impl]
    n_leaves = len(leaves(state.params))
    assert got["counts"][kernel] == 2 * n_leaves
    assert sum(got["counts"].values()) == 2 * n_leaves
    err = max((a - b.cpu()).abs().max().item()
              for a, b in zip(leaves(got["params"]), leaves(state.params)))
    scale = max(b.abs().max().item() for b in leaves(state.params))
    assert err <= 1e-5 * scale


# (p4)'s leaf blocks at (A, M) = (1, 2): DeepSeek-V2-Lite's embed.table
# block (51,200 × 2,048), one MoE group's block of 32 experts' wi (32 ×
# 2,048 × 1,408), the router's columns (2,048 × 32), the kv norm (512)
P4_LEAF_BLOCKS = [102_400 // 2 * 2_048, 32 * 2_048 * 1_408, 2_048 * 32,
                  512]


@pytest.mark.gpu
@pytest.mark.parametrize("d", P4_LEAF_BLOCKS)
def test_cuda_p4_leaf_block_mix_matches_plain_version(cuda, d):
    """#1 at (p4)'s leaf-block widths (two agents a rank): one launch a
    block, within 1e-5·max|y| of the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d)
    w = torch.rand((2, 2), device=cuda, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    x = torch.randn((2, d), device=cuda, generator=gen)
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(w, x)
    assert ops.gossip_mix.launches == before + 1
    want = ref.gossip_mix(w, x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_cuda_tp_moe_mla_tree_step_equals_one_device(cuda, tmp_path):
    """test_cuda_tp_tree_step_equals_one_device for DeepSeek-V2-Lite's
    smoke config at 3 layers (MLA on the rank's heads, the MoE on its
    experts) under 'pallas': within 1e-5·max|x|, #1 once per leaf block
    a step on each rank."""
    import pickle

    import torch.multiprocessing as mp
    from repro_torch.core import feddec
    from repro_torch.tree import leaves
    arch = "deepseek-v2-lite-16b"
    out_path = tmp_path / "out.pkl"
    mp.start_processes(_tp_world_rank, args=(2, str(tmp_path / "store"),
                                             str(out_path), "pallas", arch),
                       nprocs=2, start_method="spawn", join=True)
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    cfg, fcfg, state, batches = _tp_setup("pallas", arch)
    step = feddec.make_feddec_step(fcfg, build_model(cfg).grad_fn(),
                                   lambda t: 1e-2, device="cuda")
    draws = Draws(4, "cuda")
    for batch in batches:
        state, _ = step(state, batch, draws)
    n_leaves = len(leaves(state.params))
    assert got["counts"]["gossip_mix"] == 2 * n_leaves
    assert sum(got["counts"].values()) == 2 * n_leaves
    err = max((a - b.cpu()).abs().max().item()
              for a, b in zip(leaves(got["params"]), leaves(state.params)))
    scale = max(b.abs().max().item() for b in leaves(state.params))
    assert err <= 1e-5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("s", [640, 1024, 1536])
def test_cuda_chunked_prefill_matches_the_one_block(cuda, s, dtype, tol):
    """The chunked prefill (chunks of 512; one block at 640) against the
    one block on the card, causal with a window of 300: within
    1e-5·max|y| in f32, one bf16 step (2^-7·max|y|) in bf16."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(s)
    q = torch.randn((2, s, 8, 64), device=cuda, generator=gen).to(dtype)
    k = torch.randn((2, s, 2, 64), device=cuda, generator=gen).to(dtype)
    v = torch.randn((2, s, 2, 64), device=cuda, generator=gen).to(dtype)
    pos = torch.arange(s, device=cuda).expand(2, s)
    got = attention._chunked_prefill(q, k, v, pos, pos, 0.125, 300)
    want = attention._attend_block(q, k, v, pos, pos, 0.125, 300)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
