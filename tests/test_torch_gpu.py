"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(the kernels have no CPU mode).  The file imports no jax, so it runs on a
machine that has PyTorch and a card only:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: max abs error ≤ 1e-5·max|y| in f32 (another summation order;
TF32 is off).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import topology as topo
from repro_torch.kernels import ops, ref

SHAPES = [(1, 1), (5, 1000003), (8, 4099), (13, 3001), (37, 1031),
          (256, 10007)]


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


@pytest.mark.gpu
def test_cuda_launches_are_counted(cuda):
    ops.reset_launch_counts()
    x = torch.randn(4, 300, device=cuda)
    w = torch.rand(4, 4, device=cuda)
    ops.gossip_mix(w, x)
    ops.update_mix(w, x, x, torch.tensor([0.1], device=cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"gossip_mix": 1, "gossip_mix_sparse": 0,
                                   "update_mix": 1, "update_mix_sparse": 0}


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
