"""The port's kernels #1–#8 against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain versions (kernels/ref.py);
the reference runs its Pallas kernels in interpret mode, as its own tests
do.  Inputs are numpy arrays from a seed, handed to both.  Tolerance:
1e-6 max abs in f32 (the two sum the mix in different orders).

The CUDA kernels themselves are held against the plain versions on the
card in tests/test_torch_gpu.py.  The import rules of the port (no jax,
nothing of repro) are checked here too.
"""

from __future__ import annotations

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as ref_topo
from repro.kernels import ops as ref_ops
from repro_torch.core import topology as topo
from repro_torch.kernels import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
SHAPES = [(1, 300), (5, 1000), (8, 1299)]


def _graph(n: int):
    """(reference Graph, port Graph) on the same adjacency."""
    g = ref_topo.ring_graph(n, k=min(2, (n - 1) // 2 or 1)) if n > 2 \
        else ref_topo.Graph(np.zeros((n, n), dtype=bool))
    return g, topo.Graph(g.adjacency)


def _inputs(n: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    x, g, m = (rng.standard_normal((n, d)).astype(np.float32)
               for _ in range(3))
    return w, x, g, m


def _close(port: torch.Tensor, reference) -> float:
    return float(np.max(np.abs(port.numpy() - np.asarray(reference))))


@pytest.mark.parametrize("n,d", SHAPES)
def test_gossip_mix_plain_matches_pallas(n, d):
    w, x, _, _ = _inputs(n, d)
    want = ref_ops.gossip_mix(jnp.asarray(w), jnp.asarray(x))
    got = ops.gossip_mix(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert _close(got, want) <= TOL


@pytest.mark.parametrize("n,d", SHAPES)
def test_gossip_mix_sparse_plain_matches_pallas(n, d):
    w, x, _, _ = _inputs(n, d, seed=1)
    ref_graph, graph = _graph(n)
    want = ref_ops.make_sparse_gossip_pallas(ref_graph)(jnp.asarray(w),
                                                        jnp.asarray(x))
    got = ops.make_sparse_gossip(graph)(torch.from_numpy(w),
                                        torch.from_numpy(x))
    assert _close(got, want) <= TOL


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_update_mix_plain_matches_pallas(n, d, opt):
    w, x, g, m = _inputs(n, d, seed=2)
    eta = 0.05
    kw = {} if opt == "sgd" else {"beta": 0.9,
                                  "nesterov": opt == "nesterov"}
    jm = None if opt == "sgd" else jnp.asarray(m)
    tm = None if opt == "sgd" else torch.from_numpy(m)
    want = ref_ops.update_mix(jnp.asarray(w), jnp.asarray(x), jnp.asarray(g),
                              eta, m=jm, **kw)
    got = ops.update_mix(torch.from_numpy(w), torch.from_numpy(x),
                         torch.from_numpy(g), torch.tensor([eta]), tm, **kw)
    if opt == "sgd":
        assert _close(got, want) <= TOL
    else:
        assert _close(got[0], want[0]) <= TOL
        assert _close(got[1], want[1]) <= TOL


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_update_mix_sparse_plain_matches_pallas(n, d, opt):
    w, x, g, m = _inputs(n, d, seed=3)
    ref_graph, graph = _graph(n)
    beta = None if opt == "sgd" else 0.9
    nesterov = opt == "nesterov"
    want = ref_ops.make_sparse_update_mix_pallas(
        ref_graph, beta=beta, nesterov=nesterov)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(g), 0.05,
        None if beta is None else jnp.asarray(m))
    got = ops.make_sparse_update_mix(graph, beta=beta, nesterov=nesterov)(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(g),
        torch.tensor([0.05]), None if beta is None else torch.from_numpy(m))
    if beta is None:
        assert _close(got, want) <= TOL
    else:
        assert _close(got[0], want[0]) <= TOL
        assert _close(got[1], want[1]) <= TOL


BATCHED_SHAPES = [(1, 5, 777), (3, 8, 3001), (2, 13, 1031)]


def _lattice_graphs(r: int, n: int):
    """(reference graphs, port graphs): per-run topologies of different
    degrees, the last one edgeless when R > 1."""
    graphs = [ref_topo.ring_graph(n, k=1 + (i % 2)) for i in range(r)]
    if r > 1:
        graphs[-1] = ref_topo.Graph(np.zeros((n, n), dtype=bool))
    return graphs, [topo.Graph(g.adjacency) for g in graphs]


def _batched_inputs(r: int, n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.random((r, n, n)).astype(np.float32)
    x, g, m = (rng.standard_normal((r, n, d)).astype(np.float32)
               for _ in range(3))
    eta = (0.05 * (1 + np.arange(r))).astype(np.float32)
    return w, x, g, m, eta


@pytest.mark.parametrize("r,n,d", BATCHED_SHAPES)
def test_gossip_mix_batched_plain_matches_pallas(r, n, d):
    w, x, _, _, _ = _batched_inputs(r, n, d, seed=4)
    want = ref_ops.gossip_mix_batched(jnp.asarray(w), jnp.asarray(x))
    got = ops.gossip_mix_batched(torch.from_numpy(w), torch.from_numpy(x))
    assert got.shape == (r, n, d) and _close(got, want) <= TOL


@pytest.mark.parametrize("r,n,d", BATCHED_SHAPES)
def test_gossip_mix_sparse_batched_plain_matches_pallas(r, n, d):
    w, x, _, _, _ = _batched_inputs(r, n, d, seed=5)
    ref_graphs, graphs = _lattice_graphs(r, n)
    want = ref_ops.make_sparse_gossip_batched_pallas(ref_graphs)(
        jnp.asarray(w), jnp.asarray(x))
    got = ops.make_sparse_gossip_batched(graphs)(torch.from_numpy(w),
                                                 torch.from_numpy(x))
    assert _close(got, want) <= TOL


@pytest.mark.parametrize("r,n,d", BATCHED_SHAPES)
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_update_mix_batched_plain_matches_pallas(r, n, d, opt):
    w, x, g, m, eta = _batched_inputs(r, n, d, seed=6)
    beta = None if opt == "sgd" else 0.9
    kw = {"beta": beta, "nesterov": opt == "nesterov"}
    want = ref_ops.update_mix_batched(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(g), jnp.asarray(eta),
        m=None if beta is None else jnp.asarray(m), **kw)
    got = ops.update_mix_batched(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(eta), None if beta is None else torch.from_numpy(m),
        **kw)
    for a, b in zip(got if beta else (got,), want if beta else (want,)):
        assert _close(a, b) <= TOL


@pytest.mark.parametrize("r,n,d", BATCHED_SHAPES)
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_update_mix_sparse_batched_plain_matches_pallas(r, n, d, opt):
    w, x, g, m, eta = _batched_inputs(r, n, d, seed=7)
    ref_graphs, graphs = _lattice_graphs(r, n)
    beta = None if opt == "sgd" else 0.9
    nesterov = opt == "nesterov"
    want = ref_ops.make_sparse_update_mix_batched_pallas(
        ref_graphs, beta=beta, nesterov=nesterov)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(g), jnp.asarray(eta),
        None if beta is None else jnp.asarray(m))
    got = ops.make_sparse_update_mix_batched(
        graphs, beta=beta, nesterov=nesterov)(
        torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(eta), None if beta is None else torch.from_numpy(m))
    for a, b in zip(got if beta else (got,), want if beta else (want,)):
        assert _close(a, b) <= TOL


@pytest.mark.parametrize("kernel", ["gossip", "sparse", "update",
                                    "update_sparse"])
def test_batched_plain_slices_equal_single_run(kernel):
    """Each run's slice of a batched plain version is the single-run plain
    version on that slice, with that run's η and (unpadded) ELL table."""
    r, n, d = 3, 8, 301
    w, x, g, m, eta = map(torch.from_numpy, _batched_inputs(r, n, d, 8))
    _, graphs = _lattice_graphs(r, n)
    if kernel == "gossip":
        y = ops.gossip_mix_batched(w, x)
        each = [ops.gossip_mix(w[i], x[i]) for i in range(r)]
    elif kernel == "sparse":
        y = ops.make_sparse_gossip_batched(graphs)(w, x)
        each = [ops.make_sparse_gossip(gr)(w[i], x[i])
                for i, gr in enumerate(graphs)]
    elif kernel == "update":
        y, _ = ops.update_mix_batched(w, x, g, eta, m, beta=0.9)
        each = [ops.update_mix(w[i], x[i], g[i], eta[i:i + 1], m[i],
                               beta=0.9)[0] for i in range(r)]
    else:
        y = ops.make_sparse_update_mix_batched(graphs)(w, x, g, eta)
        each = [ops.make_sparse_update_mix(gr)(w[i], x[i], g[i],
                                               eta[i:i + 1])
                for i, gr in enumerate(graphs)]
    for i in range(r):
        assert torch.equal(y[i], each[i])


@pytest.mark.parametrize("n", [1, 5, 8, 13])
def test_ell_table_matches_reference_unpadded(n):
    ref_graph, graph = _graph(n)
    nbr, mask = ops.ell_table(graph.adjacency)
    rnbr, rmask, rn, _, rdeg = ref_ops._ell_table(ref_graph.adjacency)
    assert nbr.shape == (n, rdeg) and rn == n
    np.testing.assert_array_equal(nbr, rnbr[:n])
    np.testing.assert_array_equal(mask, rmask[:n])


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launch_counts()
    w, x, g, m = _inputs(5, 64)
    tw, tx, tg, tm = map(torch.from_numpy, (w, x, g, m))
    ops.gossip_mix(tw, tx)
    ops.update_mix(tw, tx, tg, torch.tensor([0.1]), tm, beta=0.9)
    ops.gossip_mix_batched(tw[None], tx[None])
    ops.update_mix_batched(tw[None], tx[None], tg[None], torch.tensor([0.1]),
                           tm[None], beta=0.9)
    ops.ef_mix(tw, tx, tg, tm)
    scale = torch.ones(5)
    _, q = ops.quant_mix(tw, tx, tg.abs().clamp(max=0.5), tm, scale)
    ops.dequant_mix(tw, q, scale, tm)
    ops.ef_mix_batched(tw[None], tx[None], tg[None], tm[None])
    ops.make_sparse_ef_mix_batched([topo.ring_graph(5, k=1)])(
        tw[None], tx[None], tg[None], tm[None])
    qkv = tx.reshape(1, 5, 1, 64)
    ops.flash_attention(qkv, qkv, qkv)
    ops.ssd_scan(qkv.reshape(1, 5, 4, 16), torch.ones(1, 5, 4),
                 -torch.ones(4), tx[:, :8][None], tx[:, 8:16][None])
    ops.rglru_scan(tx[None], tg[None])
    assert ops.launch_counts() == {
        name: 0 for name in ("gossip_mix", "gossip_mix_sparse", "update_mix",
                             "update_mix_sparse", "gossip_mix_batched",
                             "gossip_mix_sparse_batched",
                             "update_mix_batched",
                             "update_mix_sparse_batched", "ef_mix",
                             "ef_mix_sparse", "quant_mix", "dequant_mix",
                             "ef_mix_batched", "ef_mix_sparse_batched",
                             "flash_attention", "ssd_scan", "rglru_scan")}


@pytest.mark.parametrize("bad", ["rank", "w_shape", "eta_shape",
                                 "ell_shape"])
def test_batched_wrappers_reject_what_the_kernels_do_not_take(bad):
    w, x, g, m, eta = map(torch.from_numpy, _batched_inputs(2, 4, 33, 9))
    nbr = torch.zeros(2, 4, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "rank":
            ops.gossip_mix_batched(w[0], x[0])
        elif bad == "w_shape":
            ops.gossip_mix_batched(w[:1], x)
        elif bad == "eta_shape":
            ops.update_mix_batched(w, x, g, torch.tensor([0.1, 0.2, 0.3]))
        else:
            ops.gossip_mix_sparse_batched(nbr[:1], torch.zeros(1, 4, 1),
                                          torch.ones(1, 4), x)


@pytest.mark.parametrize("bad", ["dtype", "shape", "m_without_beta",
                                 "beta_without_m", "eta_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    w, x, g, m = map(torch.from_numpy, _inputs(4, 33))
    eta = torch.tensor([0.1])
    with pytest.raises((TypeError, ValueError)):
        if bad == "dtype":
            ops.gossip_mix(w, x.half())  # the kernels take f32 and f64
        elif bad == "shape":
            ops.gossip_mix(w[:3], x)
        elif bad == "m_without_beta":
            ops.update_mix(w, x, g, eta, m)
        elif bad == "beta_without_m":
            ops.update_mix(w, x, g, eta, beta=0.9)
        else:
            ops.update_mix(w, x, g, torch.tensor([0.1, 0.2]))


def test_plain_local_step_follows_reference_dtype_rules():
    """η is cast to x's dtype; the momentum slot stays f32."""
    _, x, g, m = _inputs(3, 17)
    p, new_m = ref.local_step(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(m), torch.tensor([0.5]),
                              0.9, True)
    g32 = g.astype(np.float32)
    m1 = np.float32(0.9) * m + g32
    step = np.float32(0.9) * m1 + g32
    np.testing.assert_allclose(new_m.numpy(), m1, rtol=0, atol=1e-7)
    np.testing.assert_allclose(p.numpy(), x - np.float32(0.5) * step,
                               rtol=0, atol=1e-6)
    assert new_m.dtype == torch.float32


# ---------------------------------------------------------------------------
# Import rules of the port
# ---------------------------------------------------------------------------


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {mod}"
