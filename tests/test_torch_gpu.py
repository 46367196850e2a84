"""The port's CUDA kernels (#1–#8) against their plain versions, on the
card.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(the kernels have no CPU mode).  The file imports no jax, so it runs on a
machine that has PyTorch and a card only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: max abs error ≤ 1e-5·max|y| in f32 (another summation order;
TF32 is off).  A run's slice of a batched kernel (#5–#8) equals the
single-run kernel (#1–#4) on that slice exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import gossip
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
        "update_mix_sparse_batched": 3}


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
