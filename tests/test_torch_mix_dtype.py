"""The port's float64 gossip mixes against the JAX package's, in x64 mode.

The reference mixes a float64 buffer two ways.  Its plain mixes cast W to
the buffer's dtype and mix in float64 (repro/core/engine.py:155-158 and
:180-183, repro/core/gossip.py:112-132): 'dense' everywhere, and 'sparse'
off the TPU.  Its Pallas kernels load and store float64 but mix in f32
(repro/kernels/gossip_mix.py:41-44, update_mix.py:_local_step): 'pallas',
the fused update+mix, and 'sparse' on the TPU.  The port's mix kernels do
what the reference's kernels do, on the card and (their plain versions)
on the CPU, so the port's 'sparse' is held to the reference's engine as
it runs on the TPU (``on_tpu`` patched to true, its kernels in interpret
mode).  fig4 (benchmarks/fig4_convergence.py) runs 'dense' in float64
because f32 loses its suboptimality signal.

The inputs are made with numpy from a seed at fig4's shape (n 20 agents,
D 25, geographic graphs of radius 0.5, x scaled by 2^20).  The plain f64
mixes (dense, CSR, a lattice's stacked ELL past the kernel's range) are
held to 1e-14·max|y| (the f32 detour they replaced erred about 1e-7);
the kernels' mixes, whose sums are f32 as the reference kernels' are but
rounded in another order (and by fused multiply-adds), to 1e-6·max|y|.  The x64 switch is a context manager here, never
``jax.config.update``, so it does not leak into other test files on the
same worker.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import engine as ref_engine
from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.kernels import ops as ref_ops
from repro_torch.core import engine, flat as flat_lib, sweep
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.gossip import stacked_ell_tables
from repro_torch.core.mixing import MixingDistribution
from repro_torch.kernels import ops
from test_torch_engine import ReplayDraws
from test_torch_sweep import ReplaySweepDraws

N, D = 20, 25
TOL = 1e-14                     # × max|y|: f64, other summation order
TOL_MM = 1e-6                   # × max|y|: an f32 sum, other rounding
X_SCALE = 2.0 ** 20             # fig4's c_20 = 2^20 heterogeneity
F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16
JNP = {F64: jnp.float64, F32: jnp.float32}


@pytest.fixture
def ref_on_tpu(monkeypatch):
    """The reference's engine as it runs on the TPU: 'sparse' takes its
    ELL kernels (repro/core/engine.py:172, :195), in interpret mode."""
    monkeypatch.setattr(ref_ops, "on_tpu", lambda: True)


def _graphs(kind: str, seed: int = 1):
    """(reference graph, port graph): fig4's geographic graph (max degree
    within the ELL range), or a star whose hub (degree 19) takes the CSR
    gather."""
    if kind == "geo":
        g = ref_topo.geographic_graph(N, 0.5, seed=seed)
    else:
        adj = np.zeros((N, N), dtype=bool)
        adj[0, 1:] = adj[1:, 0] = True
        g = ref_topo.Graph(adj)
    return g, topo.Graph(g.adjacency)


def _configs(kind, impl, p_fail=0.0, w_dtype=F64, seed=1, **kw):
    ref_graph, graph = _graphs(kind, seed)
    scheme = "metropolis" if p_fail else "laplacian"
    return (RefFedDecConfig(mixing=RefMixing(ref_graph, p_fail=p_fail,
                                             scheme=scheme,
                                             dtype=JNP[w_dtype]),
                            gossip_impl=impl, **kw),
            FedDecConfig(mixing=MixingDistribution(graph, p_fail=p_fail,
                                                   scheme=scheme,
                                                   dtype=w_dtype),
                         gossip_impl=impl, **kw))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) * X_SCALE


def _tol(kind: str, impl: str) -> float:
    """The kernels' mixes ('pallas', and 'sparse' on a graph or lattice in
    the ELL range: 'geo', 'ell') sum in f32, rounded otherwise than the
    reference's XLA sums; the plain f64 mixes to 1e-14."""
    kernel = impl == "pallas" or (impl == "sparse" and kind in ("geo",
                                                                "ell"))
    return TOL_MM if kernel else TOL


def _assert_close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want).dtype
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= tol * scale


# (graph, impl, p_fail, W dtype): fixed W in f64 and, as fig4 leaves it,
# in f32 beside the f64 buffer; link failures resampled in f64
FLAT_CELLS = [("geo", "dense", 0.0, F64), ("geo", "dense", 0.0, F32),
              ("geo", "dense", 0.3, F64), ("geo", "pallas", 0.0, F64),
              ("geo", "pallas", 0.3, F64), ("geo", "sparse", 0.0, F64),
              ("geo", "sparse", 0.0, F32), ("geo", "sparse", 0.3, F64),
              ("star", "sparse", 0.0, F64), ("star", "sparse", 0.3, F64)]


@pytest.mark.parametrize("kind,impl,p_fail,w_dtype", FLAT_CELLS, ids=[
    f"{k}-{'csr' if k == 'star' else i}-p{p}-{str(w).split('.')[1]}"
    for k, i, p, w in FLAT_CELLS])
@pytest.mark.parametrize("x_dtype", [F64, F32])
def test_flat_f64_mix_matches_reference(kind, impl, p_fail, w_dtype,
                                        x_dtype, ref_on_tpu):
    """An f64 (or f32) buffer mixed with an f64 (or f32) W^t, each pairing
    the reference takes."""
    rcfg, cfg = _configs(kind, impl, p_fail, w_dtype)
    x = _x((N, D)).astype(JNP[x_dtype])
    key = jax.random.key(5)
    with jax.enable_x64(True):
        w_ref = rcfg.mixing.sample(key)
        y_ref = ref_engine.resolve_gossip(rcfg, "flat")(w_ref,
                                                        jnp.asarray(x))
        draws = ReplayDraws(None)
        draws._keys = lambda t: [key]
        w = cfg.mixing.make_sampler("cpu")(draws, 1)
    assert w.dtype == w_dtype
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0,
                               atol=1e-15)
    y = engine.resolve_gossip(cfg, "flat")(w, torch.from_numpy(x))
    # an f32 buffer: f32 rounding and the library's order of summation
    _assert_close(y, y_ref, _tol(kind, impl) if x_dtype == F64 else TOL_MM)


# per-run (graph kind, graph seed, p_fail): a fixed W, a run with link
# failures and a second geographic graph; a star member takes the
# lattice past the ELL range (the plain stacked-ELL mix, as the reference)
LATTICES = {"ell": [("geo", 1, 0.0), ("geo", 1, 0.3), ("geo", 2, 0.0)],
            "wide": [("geo", 1, 0.3), ("star", 0, 0.0), ("star", 0, 0.2)]}


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("lattice", sorted(LATTICES))
@pytest.mark.parametrize("x_dtype", [F64, F32])
def test_lattice_f64_mix_matches_reference(impl, lattice, x_dtype,
                                           ref_on_tpu):
    """Every run's W^t in f64, on an f64 (or f32) lattice buffer."""
    pairs = [_configs(kind, impl, p, F64, seed)
             for kind, seed, p in LATTICES[lattice]]
    x = _x((len(pairs), N, D), seed=1).astype(JNP[x_dtype])
    keys = jax.random.split(jax.random.key(9), len(pairs))
    with jax.enable_x64(True):
        ref_plan = ref_sweep.make_sweep_plan([p[0] for p in pairs])
        w_ref = ref_sweep.make_sweep_w_sampler(ref_plan)(keys)
        y_ref = ref_sweep.resolve_sweep_gossip(ref_plan)(w_ref,
                                                         jnp.asarray(x))
        plan = sweep.make_sweep_plan([p[1] for p in pairs])
        draws = ReplaySweepDraws(keys)
        draws._key = lambda r, t, which: keys[r]
        w = sweep.make_sweep_w_sampler(plan, "cpu")(draws,
                                                    np.zeros(len(pairs), int))
    assert plan.w_dtype == F64 and w.dtype == F64
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0,
                               atol=1e-15)
    y = sweep.resolve_sweep_gossip(plan)(w, torch.from_numpy(x))
    _assert_close(y, y_ref, _tol(lattice, impl) if x_dtype == F64
                  else TOL_MM)


def test_lattice_with_mixed_mixing_dtypes_is_rejected_like_the_reference():
    pairs = [_configs("geo", "dense", 0.0, F64),
             _configs("geo", "dense", 0.0, F32)]
    with pytest.raises(ValueError) as ref_err:
        ref_sweep.make_sweep_plan([p[0] for p in pairs])
    with pytest.raises(ValueError) as err:
        sweep.make_sweep_plan([p[1] for p in pairs])
    assert str(err.value) == str(ref_err.value) == \
        "mixing dtype must be shared across the lattice"


# -- the mix kernels on f64 buffers -----------------------------------------
#
# Each wrapper on CPU tensors runs its kernel's plain version, the function
# the chip check holds the CUDA kernel to; here it is held to the
# reference's Pallas kernel on the same f64 inputs (W in f64, as fig4 samples
# it, so #9/#10's diagonal correction takes W_ii in f64).

MIX_KERNELS = ["gossip_mix", "gossip_mix_sparse", "update_mix",
               "update_mix_sparse", "gossip_mix_batched",
               "gossip_mix_sparse_batched", "update_mix_batched",
               "update_mix_sparse_batched", "ef_mix", "ef_mix_sparse",
               "ef_mix_batched", "ef_mix_sparse_batched", "quant_mix",
               "dequant_mix"]
R = 2
# the buffers a kernel loads and stores in the buffer's dtype (bf16 when
# the inputs carry "bf16"; W, η, m, the noise and the scales stay f32)
BUFFERS = ("x", "g", "p", "s", "u")


def _kernel_inputs(batched: bool, d: int = D):
    rng = np.random.default_rng(7)
    lead = (R,) if batched else ()
    graphs = [_graphs("geo", seed)[1] for seed in (1, 2)][:R if batched
                                                          else 1]
    w = np.stack([topo.build_weights(g, "laplacian") for g in graphs])
    t = {"w": w if batched else w[0],
         "graphs": graphs,
         "eta": np.array([0.05, 0.02][:R if batched else 1], np.float32)}
    for name in BUFFERS:
        t[name] = rng.standard_normal(lead + (N, d)) * X_SCALE
    t["m"] = rng.standard_normal(lead + (N, d)).astype(np.float32)
    t["noise"] = rng.random((N, d), dtype=np.float32)
    t["scale"] = (np.abs(t["u"]).max(axis=-1) / 127.0).astype(np.float32) \
        if not batched else None
    t["q"] = rng.integers(-127, 128, (N, d)).astype(np.int8)
    return t


def _port_kernel(kernel: str, t: dict, beta, nesterov: bool = True):
    bf16 = t.get("bf16", False)
    tt = {k: torch.from_numpy(v).to(BF16) if bf16 and k in BUFFERS
          else torch.from_numpy(v) for k, v in t.items()
          if isinstance(v, np.ndarray)}
    batched = kernel.endswith("_batched")
    kw = {} if beta is None else {"beta": beta, "nesterov": nesterov}
    m = None if beta is None else tt["m"]
    if "sparse" in kernel:
        g = t["graphs"]
        make = {"gossip_mix_sparse": ops.make_sparse_gossip,
                "update_mix_sparse": ops.make_sparse_update_mix,
                "ef_mix_sparse": ops.make_sparse_ef_mix}[
                    kernel.replace("_batched", "")] if not batched else {
                "gossip_mix_sparse_batched": ops.make_sparse_gossip_batched,
                "update_mix_sparse_batched":
                    ops.make_sparse_update_mix_batched,
                "ef_mix_sparse_batched": ops.make_sparse_ef_mix_batched}[
                    kernel]
        fn = make(g if batched else g[0], **kw) if "update" in kernel \
            else make(g if batched else g[0])
        if "update" in kernel:
            return fn(tt["w"], tt["x"], tt["g"], tt["eta"], m)
        if "ef" in kernel:
            return fn(tt["w"], tt["p"], tt["s"], tt["u"])
        return fn(tt["w"], tt["x"])
    fn = getattr(ops, kernel)
    if kernel.startswith("update"):
        return fn(tt["w"], tt["x"], tt["g"], tt["eta"], m, **kw)
    if kernel.startswith("ef"):
        return fn(tt["w"], tt["p"], tt["s"], tt["u"])
    if kernel == "quant_mix":
        return fn(tt["w"], tt["u"], tt["noise"], tt["p"], tt["scale"])
    if kernel == "dequant_mix":
        return fn(tt["w"], tt["q"], tt["scale"], tt["p"])
    return fn(tt["w"], tt["x"])


def _ref_kernel(kernel: str, t: dict, beta, nesterov: bool = True):
    bf16 = t.get("bf16", False)
    j = {k: jnp.asarray(v, jnp.bfloat16) if bf16 and k in BUFFERS
         else jnp.asarray(v) for k, v in t.items()
         if isinstance(v, np.ndarray)}
    batched = kernel.endswith("_batched")
    kw = {} if beta is None else {"beta": beta, "nesterov": nesterov}
    m = None if beta is None else j["m"]
    ref_graphs = [ref_topo.Graph(g.adjacency) for g in t["graphs"]]
    eta = j["eta"] if batched else j["eta"][0]
    if "sparse" in kernel:
        base = {"gossip_mix_sparse": "sparse_gossip",
                "update_mix_sparse": "sparse_update_mix",
                "ef_mix_sparse": "sparse_ef_mix"}[
                    kernel.replace("_batched", "")]
        make = getattr(ref_ops, f"make_{base}_batched_pallas" if batched
                       else f"make_{base}_pallas")
        fn = make(ref_graphs if batched else ref_graphs[0], **kw) \
            if "update" in kernel else make(ref_graphs if batched
                                            else ref_graphs[0])
        if "update" in kernel:
            return fn(j["w"], j["x"], j["g"], eta, m)
        if "ef" in kernel:
            return fn(j["w"], j["p"], j["s"], j["u"])
        return fn(j["w"], j["x"])
    fn = getattr(ref_ops, kernel)
    if kernel.startswith("update"):
        return fn(j["w"], j["x"], j["g"], eta, m=m, **kw)
    if kernel.startswith("ef"):
        return fn(j["w"], j["p"], j["s"], j["u"])
    if kernel == "quant_mix":
        return fn(j["w"], j["u"], j["noise"], j["p"], j["scale"])
    if kernel == "dequant_mix":
        return fn(j["w"], j["q"], j["scale"], j["p"])
    return fn(j["w"], j["x"])


def _kernel_cells():
    for kernel in MIX_KERNELS:
        for beta in ((None, 0.9) if kernel.startswith("update")
                     else (None,)):
            yield kernel, beta


@pytest.mark.parametrize("kernel,beta", list(_kernel_cells()), ids=[
    f"{k}-{'sgd' if b is None else 'nesterov'}"
    if k.startswith("update") else k for k, b in _kernel_cells()])
def test_f64_mix_kernels_match_the_reference_kernels(kernel, beta):
    """y (and m', the residual or the int8 payload) in the buffer's dtype:
    the optimizer step, the EF residual and correction in f64, the mix's
    sum in f32, as the reference's Pallas kernels compute them."""
    t = _kernel_inputs(kernel.endswith("_batched"))
    with jax.enable_x64(True):
        want = _ref_kernel(kernel, t, beta)
    got = _port_kernel(kernel, t, beta)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    assert got[0].dtype == F64
    _assert_close(got[0], want[0], TOL_MM)
    for g_, w_ in zip(got[1:], want[1:]):   # m' f32, r f64, q int8: exact
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


def _bf16_kernel_inputs(batched: bool):
    """The f64 cells' inputs at D 1000 (ragged for every tile), the
    buffers unscaled and rounded to bf16 (held as f32 numpy, exactly
    representable), W and the scales in f32."""
    t = _kernel_inputs(batched, d=1000)
    for name in BUFFERS:
        t[name] = np.array(jnp.asarray(t[name] / X_SCALE, jnp.bfloat16)
                           .astype(jnp.float32))
    t["w"] = t["w"].astype(np.float32)
    if not batched:
        t["scale"] = (np.abs(t["u"]).max(axis=-1) / 127.0).astype(np.float32)
    t["bf16"] = True
    return t


def _bf16_cells():
    for kernel in MIX_KERNELS:
        steps = ("sgd", "momentum", "nesterov") if kernel.startswith(
            "update") else (None,)
        for step in steps:
            yield kernel, step


@pytest.mark.parametrize("kernel,step", list(_bf16_cells()), ids=[
    k if s is None else f"{k}-{s}" for k, s in _bf16_cells()])
def test_bf16_mix_kernels_match_the_reference_kernels(kernel, step):
    """A bf16 buffer through every mix kernel's plain version against the
    reference's Pallas kernel (interpret mode).  m', the EF residual and
    the int8 payload equal the reference's element for element.  y does
    too, but for at most 1e-3 of its elements, each within 2^-7·max|y|
    (one bf16 ulp at the top): the ELL and int8 mixes sum in f32 in
    another order than XLA's (contracted multiply-adds; the f64 cells
    hold them to 1e-6), which moves a bf16 rounding only where the f32
    sum lies within an f32 ulp of a bf16 tie (an EF correction that
    cancels its mix keeps the mix's ulp).  The fused update follows XLA's rounding of
    the reference's kernel body: η·step rounded to bf16, x − η·step kept
    in f32 for the mix, β·m + g a fused multiply-add.  Its sgd, momentum
    and nesterov cells fail on an op-by-op bf16 step (x − η·g rounded to
    bf16 before the mix), which is one bf16 ulp off in about 40% of y's
    elements."""
    t = _bf16_kernel_inputs(kernel.endswith("_batched"))
    beta = None if step in (None, "sgd") else 0.9
    nesterov = step == "nesterov"
    want = _ref_kernel(kernel, t, beta, nesterov)
    got = _port_kernel(kernel, t, beta, nesterov)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == {jnp.bfloat16: BF16, jnp.float32: F32,
                            jnp.int8: torch.int8}[w_.dtype.type]
    _assert_bf16_within_an_ulp(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_.float().numpy(),
                                      np.asarray(w_.astype(jnp.float32)))


BF16_ULP_SHARE = 1e-3   # y's elements allowed one bf16 ulp off


def _assert_bf16_within_an_ulp(got: torch.Tensor, want) -> None:
    """got equals want but for at most ``BF16_ULP_SHARE`` of its elements,
    each within 2^-7·max|want|."""
    assert got.dtype == BF16
    a, b = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    off = a != b
    assert np.abs(a - b).max() <= 2.0 ** -7 * np.abs(b).max()
    assert off.mean() <= BF16_ULP_SHARE, off.mean()


def test_bf16_pallas_and_dense_round_w_differently_like_the_reference():
    """'pallas' (kernel #1) mixes a bf16 buffer with W in f32, 'dense'
    with W rounded to bf16 first (repro/core/engine.py:157 against
    repro/kernels/ops.py:199): on ring2's Metropolis W (0.2, 0.2002 in
    bf16) the two routes part in the reference and in the port alike,
    and each port route equals its reference counterpart exactly."""
    g, w, x = _ring2_bf16((8, 4096))
    xj, xt = _bf16_pair(x)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    got, want = {}, {}
    for impl in ("dense", "pallas"):
        rcfg = RefFedDecConfig(mixing=RefMixing(g, scheme="metropolis"),
                               gossip_impl=impl)
        cfg = FedDecConfig(mixing=MixingDistribution(
            topo.Graph(g.adjacency), scheme="metropolis"), gossip_impl=impl)
        want[impl] = ref_engine.resolve_gossip(rcfg, "flat")(wj, xj)
        got[impl] = engine.resolve_gossip(cfg, "flat")(wt, xt)
        _assert_bf16_equal(got[impl], want[impl])
    parted = (got["dense"] != got["pallas"]).float().mean().item()
    ref_parted = float(np.mean(np.asarray(want["dense"].astype(jnp.float32))
                               != np.asarray(want["pallas"].astype(
                                   jnp.float32))))
    assert parted == ref_parted > 0.05


def test_the_mix_kernels_take_f32_and_f64_only():
    x = torch.from_numpy(_x((N, D)))
    w = torch.eye(N, dtype=F64)
    assert ops.gossip_mix(w, x).dtype == F64
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.gossip_mix(w, x.half())
    with pytest.raises(TypeError):   # g must share x's dtype
        ops.update_mix(w, x, x.float(), torch.tensor([0.1]))
    _, cfg = _configs("geo", "sparse")
    tables = ops.EllTables(*ops.ell_table(cfg.mixing.graph.adjacency))
    nbr, wv, wd = tables.weights(w, x)
    assert wv.dtype == wd.dtype == F32   # the kernels' f32 tables
    assert ops.gossip_mix_sparse(nbr, wv, wd, x).dtype == F64
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.gossip_mix_sparse(nbr, wv, wd, x.half())


def test_the_plain_stacked_ell_follows_the_buffer_dtype():
    """A lattice past the kernel's degree range takes the plain stacked
    ELL in the buffer's dtype, its weights read from W in that dtype."""
    graphs = [_graphs(k, 1)[1] for k in ("geo", "star")]
    nbr, valid, _ = stacked_ell_tables(graphs)
    w = torch.from_numpy(np.stack([topo.build_weights(g, "laplacian")
                                   for g in graphs]))
    x = torch.from_numpy(_x((2, N, D)))
    from repro_torch.core import gossip
    y = gossip.make_sparse_gossip_batched(graphs)(w, x)
    assert y.dtype == F64
    _assert_close(y, torch.matmul(w, x).numpy())


# -- bf16 buffers: W rounded to the buffer's dtype first --------------------

# the ROADMAP measurement's (8, 4096) leaf, a stacked (8, 3, 5) leaf and
# a one-column one
BF16_SHAPES = [(8, 4096), (8, 3, 5), (8, 1)]


def _ring2_bf16(shape, seed=0):
    """ring2 on 8 agents with Metropolis W (entries 0.2, which round to
    0.2002 in bf16, so a bf16 row sums to 1.00098), and a bf16 buffer of
    ``shape`` as f32 numpy (exactly representable in bf16)."""
    g = ref_topo.ring_graph(8, k=2)
    w = np.asarray(ref_topo.build_weights(g, "metropolis"), np.float32)
    x = np.random.default_rng(seed).standard_normal(shape)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return g, w, x


def _bf16_pair(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def _assert_bf16_equal(got: torch.Tensor, want) -> None:
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=str)
def test_bf16_plain_mixes_round_w_to_the_buffer_dtype(shape):
    """The reference casts W to a bf16 buffer's dtype before its plain
    mixes (repro/core/gossip.py:60 for the tree, core/engine.py:157 and
    :182 for the flat buffer and the lattice); the port's 'dense' mixes
    do too, and take the product in f32 as XLA takes a bf16 product.
    Tolerance 0.0: the tree leaf, the flat buffer and a two-run lattice
    equal the reference's element for element (with W kept in f32, 18%
    of the (8, 4096) leaf's elements differed, by up to 4.4e-3·max|y|)."""
    g, w, x = _ring2_bf16(shape)
    rcfg = RefFedDecConfig(mixing=RefMixing(g, scheme="metropolis"))
    cfg = FedDecConfig(mixing=MixingDistribution(topo.Graph(g.adjacency),
                                                 scheme="metropolis"))
    xj, xt = _bf16_pair(x)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    want = ref_engine.resolve_gossip(rcfg, "tree")(wj, {"a": xj})["a"]
    _assert_bf16_equal(engine.resolve_gossip(cfg, "tree")(
        wt, {"a": xt})["a"], want)

    rows = x.reshape(8, -1)
    rj, rt = _bf16_pair(rows)
    _assert_bf16_equal(engine.resolve_gossip(cfg, "flat")(wt, rt),
                       ref_engine.resolve_gossip(rcfg, "flat")(wj, rj))

    other = RefMixing(ref_topo.ring_graph(8, k=1), scheme="metropolis")
    w2 = np.stack([w, np.asarray(other.fixed_w, np.float32)])
    x2 = np.stack([rows, rows[::-1]])
    lj, lt = _bf16_pair(x2)
    plan = sweep.make_sweep_plan([cfg, cfg])
    ref_plan = ref_sweep.make_sweep_plan([rcfg, rcfg])
    _assert_bf16_equal(
        engine.resolve_gossip(plan, "sweep")(torch.from_numpy(w2), lt),
        ref_engine.resolve_gossip(ref_plan, "sweep")(jnp.asarray(w2), lj))


def test_bf16_plain_stacked_ell_rounds_like_the_reference():
    """A lattice too skewed for kernel #6 (a star's hub of degree 19) takes
    the plain stacked ELL, W read in the buffer's dtype and every product
    and sum rounded to it, as the reference's
    (repro/core/gossip.py:199-211): equal element for element in bf16."""
    graphs = [_graphs(k, 1) for k in ("star", "geo")]
    w = np.stack([np.asarray(ref_topo.build_weights(g, "metropolis"),
                             np.float32) for g, _ in graphs])
    x = np.random.default_rng(3).standard_normal((2, N, 4096))
    xj, xt = _bf16_pair(np.array(jnp.asarray(x, jnp.bfloat16).astype(
        jnp.float32)))
    from repro.core import gossip as ref_gossip
    from repro_torch.core import gossip
    want = ref_gossip.make_sparse_gossip_batched([g for g, _ in graphs])(
        jnp.asarray(w), xj)
    _assert_bf16_equal(gossip.make_sparse_gossip_batched(
        [g for _, g in graphs])(torch.from_numpy(w), xt), want)


# -- the flat engine end to end in f64 --------------------------------------

H, K, ETA = 3, 2, 0.05
SHAPES = {"b": (7,), "w": {"k": (3, 6)}}   # D = 25


def _jax_loss(params, batch):
    return 0.5 * (jnp.sum(jnp.square(params["b"] - batch["tb"]))
                  + jnp.sum(jnp.square(2.0 * params["w"]["k"]
                                       - batch["tw"])))


def _torch_loss(params, batch):
    return 0.5 * (torch.sum(torch.square(params["b"] - batch["tb"]))
                  + torch.sum(torch.square(2.0 * params["w"]["k"]
                                           - batch["tw"])))


# line 4 for one agent, as the engines take it (the reference's
# jax.value_and_grad form)
_torch_grad_fn = engine.value_and_grad(_torch_loss)


def _ref_grad_fn(params, batch, key):
    del key
    return jax.value_and_grad(_jax_loss)(params, batch)


def _batches(rounds, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tb": rng.standard_normal((H, N, 7)) * X_SCALE,
             "tw": rng.standard_normal((H, N, 3, 6)) * X_SCALE}
            for _ in range(rounds)]


def _port_round(cfg, fused, flat0):
    params1 = {"b": torch.zeros(7, dtype=F64),
               "w": {"k": torch.zeros(3, 6, dtype=F64)}}
    spec = flat_lib.make_flat_spec(params1)
    assert spec.d == D and spec.dtype == F64
    state = flat_lib.flat_state_from_numpy(flat0, 1)
    eta = torch.tensor([ETA], dtype=F64)
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, _torch_grad_fn, lambda t: eta, device="cpu",
        fuse_update_mix=fused)
    return state, round_fn


ENGINE_CELLS = [("geo", "dense", 0.0, False), ("geo", "pallas", 0.0, False),
                ("geo", "sparse", 0.0, False), ("geo", "sparse", 0.3, False),
                ("star", "sparse", 0.0, False), ("geo", "dense", 0.0, True),
                ("geo", "pallas", 0.3, True), ("geo", "sparse", 0.3, True)]


@pytest.mark.parametrize("kind,impl,p_fail,fused", ENGINE_CELLS, ids=[
    f"{k}-{i}-p{p}{'-fused' if f else ''}" for k, i, p, f in ENGINE_CELLS])
def test_flat_f64_engine_matches_reference(kind, impl, p_fail, fused,
                                           ref_on_tpu):
    """Two rounds of H = 3 steps with the server; the losses keep the
    loss's dtype (f64) and agree with the reference's.  The fused
    update+mix (kernels #3/#4) sums its mix in f32 on every impl, as the
    reference's fused path does."""
    rcfg, cfg = _configs(kind, impl, p_fail, F64, h=H, k=K)
    tol = TOL_MM if fused else _tol(kind, impl)
    flat0 = _x((N, D), seed=4)
    key = jax.random.key(11)
    with jax.enable_x64(True):
        shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float64),
                              SHAPES, is_leaf=lambda s: isinstance(s, tuple))
        ref_spec = ref_flat.make_flat_spec(shapes)
        rstate = ref_flat.FlatFedState(flat=jnp.asarray(flat0),
                                       step=jnp.asarray(1, jnp.int32),
                                       opt_state=())
        round_ref = ref_flat.make_flat_feddec_round(
            rcfg, ref_spec, _ref_grad_fn,
            lambda t: jnp.asarray(ETA, jnp.float64), donate=False,
            fuse_update_mix=fused)
        state, round_fn = _port_round(cfg, fused, flat0)
        draws = ReplayDraws(key)
        for batches in _batches(2):
            rstate, rmet = round_ref(
                rstate, jax.tree.map(jnp.asarray, batches), key)
            state, met = round_fn(
                state, {k: torch.from_numpy(v) for k, v in batches.items()},
                draws)
            assert met["loss"].dtype == F64
            np.testing.assert_allclose(met["loss"].numpy(),
                                       np.asarray(rmet["loss"]),
                                       rtol=100 * tol, atol=0)
    _assert_close(state.flat, rstate.flat, tol)


@pytest.mark.parametrize("impl", ["pallas", "sparse"])
def test_fused_f64_round_equals_the_unfused_one(impl):
    """The fused update+mix (kernel #3/#4) forms p in f64 and mixes it in
    f32, as the unfused step and kernel #1/#2 do: the two rounds agree up
    to η, which the kernels take in f32 as the reference's do."""
    _, cfg = _configs("geo", impl, h=H, k=K)
    flat0 = _x((N, D), seed=4)
    out = []
    for fused in (False, True):
        state, round_fn = _port_round(cfg, fused, flat0)
        draws = ReplayDraws(jax.random.key(2))
        for batches in _batches(2):
            state, _ = round_fn(
                state, {k: torch.from_numpy(v) for k, v in batches.items()},
                draws)
        out.append(state.flat)
    _assert_close(out[1], out[0].numpy(), TOL_MM)


def test_losses_keep_the_loss_dtype():
    """grads_of's one batched call returns each row's loss in the loss's
    own dtype (the f32 engine's losses stay f32)."""
    for dtype in (F64, F32):
        params1 = {"b": torch.zeros(7, dtype=dtype),
                   "w": {"k": torch.zeros(3, 6, dtype=dtype)}}
        spec = flat_lib.make_flat_spec(params1)
        flat = torch.from_numpy(_x((4, D))).to(dtype)
        batch = {"tb": torch.ones(4, 7, dtype=dtype),
                 "tw": torch.ones(4, 3, 6, dtype=dtype)}
        losses, g = flat_lib.grads_of(spec, _torch_grad_fn, flat, batch)
        assert losses.dtype == dtype and losses.shape == (4,)
        assert g.dtype == dtype
        assert losses[0].item() == _torch_loss(
            {"b": flat[0, :7], "w": {"k": flat[0, 7:].view(3, 6)}},
            {"tb": batch["tb"][0], "tw": batch["tw"][0]}).item()


# -- the flat engine on a bf16 buffer ----------------------------------------

BF16_ENGINE_CELLS = [("pallas", False, None), ("pallas", True, None),
                     ("sparse", False, None), ("sparse", True, None),
                     ("pallas", True, "momentum"), ("sparse", True,
                                                    "nesterov")]


@pytest.mark.parametrize("impl,fused,opt", BF16_ENGINE_CELLS, ids=[
    f"{i}{'-fused' if f else ''}{'-' + o if o else ''}"
    for i, f, o in BF16_ENGINE_CELLS])
def test_flat_bf16_engine_matches_reference(impl, fused, opt, ref_on_tpu):
    """Two rounds of H = 3 steps of the quadratic on a bf16 (n, D) buffer
    with the server, through kernels #1/#2 unfused and #3/#4 fused (their
    plain versions; the reference's Pallas kernels in interpret mode): η
    is f32 and cast to bf16 before the multiply, the momentum slot f32, as
    the reference's dtype rules have it.  The buffers stay bf16 and end
    equal to the reference's element for element (tolerance 0.0, measured
    so: at D 25 no f32 sum of the ELL mixes lies at a bf16 tie;
    test_bf16_mix_kernels_match_the_reference_kernels bounds the rare
    ones that do).  The bf16 losses, summed in another order, lie within
    one bf16 step (2^-7 relative; measured one step at 14.1, 4.4e-3)."""
    from repro.optim import optimizers as ref_optim
    from repro_torch.optim import optimizers as optim
    make_opt = {None: (None, None),
                "momentum": (ref_optim.momentum_sgd(0.9),
                             optim.momentum_sgd(0.9)),
                "nesterov": (ref_optim.momentum_sgd(0.9, nesterov=True),
                             optim.momentum_sgd(0.9, nesterov=True))}[opt]
    rcfg, cfg = _configs("geo", impl, 0.0, F32, h=H, k=K)
    flat0 = np.array(jnp.asarray(np.random.default_rng(4).standard_normal(
        (N, D)), jnp.bfloat16).astype(jnp.float32))
    key = jax.random.key(11)
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.bfloat16),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    ref_spec = ref_flat.make_flat_spec(shapes)
    rstate = ref_flat.init_flat_state(
        ref_spec, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
        N, optimizer=make_opt[0])
    rstate = dataclasses.replace(rstate,
                                 flat=jnp.asarray(flat0, jnp.bfloat16))
    round_ref = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, _ref_grad_fn, lambda t: jnp.asarray(ETA, jnp.float32),
        optimizer=make_opt[0], donate=False, fuse_update_mix=fused)
    params1 = {"b": torch.zeros(7, dtype=BF16),
               "w": {"k": torch.zeros(3, 6, dtype=BF16)}}
    spec = flat_lib.make_flat_spec(params1)
    assert spec.dtype == BF16
    state = flat_lib.init_flat_state(spec, params1, N,
                                     optimizer=make_opt[1])
    state.flat = torch.from_numpy(flat0).to(BF16)
    eta = torch.tensor([ETA], dtype=F32)
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, _torch_grad_fn, lambda t: eta, optimizer=make_opt[1],
        device="cpu", fuse_update_mix=fused)
    draws = ReplayDraws(key)
    rng = np.random.default_rng(3)
    for _ in range(2):
        batches = {"tb": rng.standard_normal((H, N, 7)),
                   "tw": rng.standard_normal((H, N, 3, 6))}
        rstate, rmet = round_ref(rstate, {k: jnp.asarray(v, jnp.bfloat16)
                                          for k, v in batches.items()}, key)
        state, met = round_fn(state, {k: torch.from_numpy(v).to(BF16)
                                      for k, v in batches.items()}, draws)
        np.testing.assert_allclose(
            met["loss"].float().numpy(),
            np.asarray(rmet["loss"].astype(jnp.float32)), rtol=2.0 ** -7)
    assert state.flat.dtype == BF16
    got = state.flat.float().numpy()
    want = np.asarray(rstate.flat.astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    if opt is not None:
        assert state.opt_state.dtype == F32
