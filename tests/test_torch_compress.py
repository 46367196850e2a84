"""Compressed gossip with error feedback: the port against the JAX package.

Mirrors tests/test_compress.py's contract tests for the port's
core/compress.py (parsing, wire bytes, the int8 error bound and its
unbiasedness, top-k ties, the bf16 round trip, impl 'none' skipping the
codec, identity ≡ uncompressed, fused ≡ unfused, sparse ≡ dense), then
holds the port to the live reference:

  * codecs: from the same numpy u and the same injected noise, encode and
    decode equal the reference's bit for bit (int8 q and scale, the bf16
    payload, the top-k index set with its ties);
  * the plain versions of kernels #9, #11, #13 and #14 against the
    reference's Pallas kernels in interpret mode, at ragged n and D: y
    within 1e-5 (rtol and atol; another summation order), r and q exact;
  * the flat engine, 2 rounds of H = 3 on D = 2196 across impl {dense,
    pallas, sparse} × fused × {sgd, momentum} × {identity, bf16, int8,
    topk:0.25}, started from the reference's state after one round (its
    residual carried in by flat_state_from_numpy), under replayed draws.

Tolerances of the engine cells.  identity: 1e-5 max abs, as the
uncompressed cells (tests/test_torch_engine.py).  The lossy codecs round:
int8 floors u/scale + noise, bf16 rounds to nearest, top-k cuts at a
threshold.  The two packages sum the mix in another order, so their
iterates differ by float noise, and where that noise straddles a rounding
boundary the two runs decide it differently.  One such flip moves s_j by
one rounding step, its neighbours' y by W_ij times that, and the
residual by that, in one column only.  So a lossy cell holds: the losses
within 1e-4 relative; at least 99% of the elements of x and of the
residual within 1e-5·max|x|; every element within one rounding step
(int8: twice the largest row scale, as tests/test_compress.py:378-379
bounds the reference's own flips; bf16: one bf16 ulp of max|u|; top-k:
the largest |u| at the top-k threshold).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import compress as ref_compress
from repro.core import flat as ref_flat
from repro.core import sweep as ref_sweep
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.kernels import ops as ref_ops
from repro_torch import optim
from repro_torch.core import compress, engine, flat as flat_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.kernels import ops, ref
from test_torch_engine import (ETA, H, K, N, SHAPES, TOL, ReplayDraws,
                               _batches, _graphs, _ref_grad_fn,
                               _torch_grad_fn,
                               ref_codec_noise)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CODECS = ["identity", "bf16", "int8", "topk:0.25"]


def _bits(a) -> np.ndarray:
    """The bit pattern of an f32 array (so -0.0 and 0.0 differ)."""
    return np.asarray(a, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# Parsing, configuration, wire bytes
# ---------------------------------------------------------------------------


def test_parse_choices():
    assert compress.parse_compress("none") is None
    assert compress.parse_compress("identity").name == "identity"
    assert compress.parse_compress("bf16").name == "bf16"
    int8 = compress.parse_compress("int8")
    assert int8.name == "int8" and int8.needs_key
    topk = compress.parse_compress("topk:0.25")
    assert topk.name == "topk" and topk.ratio == 0.25
    assert compress.COMPRESS_CHOICES == ref_compress.COMPRESS_CHOICES


@pytest.mark.parametrize("bad", ["bogus", "topk:0", "topk:1.5", "topk:x",
                                 "int4"])
def test_bad_specs_raise_the_reference_message(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_compress.parse_compress(bad)
    with pytest.raises(ValueError) as err:
        compress.parse_compress(bad)
    assert str(err.value) == str(ref_err.value)


def test_feddec_config_validates():
    mixing = MixingDistribution(topo.ring_graph(6, k=1))
    with pytest.raises(ValueError, match="gossip_compress"):
        FedDecConfig(mixing=mixing, gossip_compress="bogus")
    FedDecConfig(mixing=mixing, gossip_compress="topk:0.1")


@pytest.mark.parametrize("spec", ["identity", "bf16", "int8", "topk:0.125",
                                  "topk:0.1", "topk:1"])
@pytest.mark.parametrize("d", [1, 777, 1024])
def test_wire_bytes_per_row_match_reference(spec, d):
    want = ref_compress.parse_compress(spec).wire_bytes_per_row(d)
    assert compress.parse_compress(spec).wire_bytes_per_row(d) == want
    assert compress.parse_compress(spec).wire_bytes_per_row(d, 2) == \
        ref_compress.parse_compress(spec).wire_bytes_per_row(d, 2)


def test_wire_bytes_per_row_values():
    d = 1024
    assert compress.parse_compress("identity").wire_bytes_per_row(d) == 4096
    assert compress.parse_compress("bf16").wire_bytes_per_row(d) == 2048
    assert compress.parse_compress("int8").wire_bytes_per_row(d) == 1028
    assert compress.parse_compress("topk:0.125").wire_bytes_per_row(d) \
        == 128 * 8.0


# ---------------------------------------------------------------------------
# Codecs: the port's own contract, then bit for bit against the reference
# ---------------------------------------------------------------------------


def _int8_roundtrip(u: torch.Tensor, seed: int = 0):
    comp = compress.parse_compress("int8")
    gen = torch.Generator().manual_seed(seed)
    noise = torch.rand(u.shape, generator=gen)
    payload = comp.encode(noise, u)
    return payload, comp.decode(payload, u.dtype, u.shape[1])


def test_int8_error_bounded_by_row_scale():
    rng = np.random.default_rng(1)
    mags = np.asarray([1e-3, 1.0, 50.0, 0.0, 2.0, 1e4], np.float32)
    u = torch.from_numpy(rng.standard_normal((6, 257)).astype(np.float32)
                         * mags[:, None])
    payload, s = _int8_roundtrip(u)
    scale = compress.Int8Compressor.row_scale(u)
    assert payload["q"].dtype == torch.int8
    assert ((s - u).abs() <= scale[:, None] + 1e-12).all()
    assert torch.equal(s[3], torch.zeros(257))  # a zero row decodes to 0
    assert float(scale[3]) == 1.0


@pytest.mark.parametrize("seed,mag", [(0, 1e-3), (1, 1.0), (2, 37.5),
                                      (3, 1e3)])
def test_int8_error_bounded_cases(seed, mag):
    u = torch.randn(3, 65, generator=torch.Generator().manual_seed(seed)) \
        * mag
    _, s = _int8_roundtrip(u, seed=seed)
    scale = compress.Int8Compressor.row_scale(u)
    assert ((s - u).abs() <= scale[:, None] + 1e-9).all()


def test_int8_unbiased_in_expectation():
    """E[decode(encode(u))] = u over the rounding noise: the mean of many
    independent draws lands within 5 standard errors (std ≤ scale/2)."""
    u = torch.randn(1, 64, generator=torch.Generator().manual_seed(2)) * 3.0
    trials = 4000
    _, s = _int8_roundtrip(u.expand(trials, 64).contiguous(), seed=3)
    scale = float(compress.Int8Compressor.row_scale(u)[0])
    tol = 5 * scale / 2 / np.sqrt(trials)
    assert (s.mean(dim=0) - u[0]).abs().max().item() < tol


def test_topk_keeps_largest():
    u = torch.tensor([[3.0, -5.0, 0.5, 1.0, -0.1, 2.0, 0.0, -4.0]])
    comp = compress.parse_compress("topk:0.5")
    s = comp.decode(comp.encode(None, u), u.dtype, u.shape[1])[0]
    assert s.tolist() == [3.0, -5.0, 0.0, 0.0, 0.0, 2.0, 0.0, -4.0]


def test_topk_sparsity():
    u = torch.randn(5, 100, generator=torch.Generator().manual_seed(4))
    comp = compress.parse_compress("topk:0.1")
    payload = comp.encode(None, u)
    s = comp.decode(payload, u.dtype, 100)
    assert ((s != 0).sum(dim=1) <= 10).all()
    assert payload["i"].dtype == torch.int32 and payload["i"].shape == (5,
                                                                        10)


def test_topk_ties_by_index_as_lax_top_k():
    """Equal magnitudes are kept lowest index first, as jax.lax.top_k
    keeps them (the order tests/test_delta.py pins for numpy)."""
    u = np.array([[3.0, -3.0, 1.0, 3.0, -1.0, 0.5, -3.0, 2.0],
                  [0.0] * 8, [1.0, -1.0] * 4], np.float32)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(u)), 3)
    payload = compress.parse_compress("topk:0.375").encode(
        None, torch.from_numpy(u))
    np.testing.assert_array_equal(payload["i"].numpy(),
                                  np.sort(np.asarray(want), axis=1))
    assert payload["i"][0].tolist() == [0, 1, 3]


def test_bf16_roundtrip():
    u = torch.randn(4, 64, generator=torch.Generator().manual_seed(5))
    comp = compress.parse_compress("bf16")
    payload = comp.encode(None, u)
    assert payload.dtype == torch.bfloat16
    s = comp.decode(payload, u.dtype, 64)
    torch.testing.assert_close(s, u, rtol=2 ** -8, atol=0)


def _codec_input(seed: int, n: int = 7, d: int = 1031) -> np.ndarray:
    """Rows at several magnitudes, an all-zero row, and rows on a coarse
    grid (many equal magnitudes at the top-k threshold)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d)).astype(np.float32)
    u[1] *= 1e4
    u[2] *= 1e-3
    u[3] = 0.0
    u[4] = rng.integers(-4, 5, d).astype(np.float32) * 0.5
    u[5] = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
    return u


@pytest.mark.parametrize("spec", ["identity", "bf16", "int8", "topk:0.25",
                                  "topk:0.1", "topk:0.5", "topk:1"])
@pytest.mark.parametrize("seed", [0, 1])
def test_codec_matches_reference_exactly(spec, seed):
    u = _codec_input(seed)
    n, d = u.shape
    keys = jax.random.split(jax.random.key(seed + 7), n)
    noise = np.asarray(ref_compress._row_noise(keys, d))
    rcomp = ref_compress.parse_compress(spec)
    comp = compress.parse_compress(spec)
    rp = rcomp.encode(keys if rcomp.needs_key else None, jnp.asarray(u))
    pp = comp.encode(torch.from_numpy(noise) if comp.needs_key else None,
                     torch.from_numpy(u))
    rs = rcomp.decode(rp, jnp.float32, d)
    ps = comp.decode(pp, torch.float32, d)
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(rs))
    if spec == "int8":
        np.testing.assert_array_equal(pp["q"].numpy(), np.asarray(rp["q"]))
        np.testing.assert_array_equal(_bits(pp["scale"].numpy()),
                                      _bits(rp["scale"]))
    elif spec == "bf16":
        np.testing.assert_array_equal(
            pp.view(torch.int16).numpy(),
            np.asarray(rp).view(np.int16))
    elif spec.startswith("topk"):
        ri, rv = np.asarray(rp["i"]), np.asarray(rp["v"])
        order = np.argsort(ri, axis=1)
        np.testing.assert_array_equal(pp["i"].numpy(),
                                      np.take_along_axis(ri, order, 1))
        np.testing.assert_array_equal(
            _bits(pp["v"].numpy()), _bits(np.take_along_axis(rv, order, 1)))


def test_init_residual():
    assert compress.init_residual(None, 4, 9, torch.float32) == ()
    res = compress.init_residual(compress.parse_compress("int8"), 4, 9,
                                 torch.float32)
    assert torch.equal(res, torch.zeros(4, 9))


# ---------------------------------------------------------------------------
# Plain versions of kernels #9, #11, #13, #14 against the reference's
# Pallas kernels (interpret mode on the CPU)
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [(5, 1031), (8, 300), (13, 517), (3, 77), (1, 129)]


def _kernel_inputs(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    graph = ref_topo.ring_graph(n, k=min(2, (n - 1) // 2)) if n >= 3 \
        else ref_topo.Graph(np.zeros((n, n), dtype=bool))
    w = np.asarray(RefMixing(graph, p_fail=0.3, scheme="metropolis").sample(
        jax.random.key(seed)), np.float32)
    p, s, u = (rng.standard_normal((n, d)).astype(np.float32)
               for _ in range(3))
    u[0] *= 40.0  # rows of different int8 scales
    noise = rng.random((n, d), dtype=np.float32)
    return graph, w, p, s, u, noise


def _assert_y(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,d", KERNEL_SHAPES)
def test_ef_mix_plain_matches_reference(n, d):
    _, w, p, s, u, _ = _kernel_inputs(n, d, seed=n + d)
    ops.reset_launch_counts()
    y, r = ops.ef_mix(*map(torch.from_numpy, (w, p, s, u)))
    want_y, want_r = ref_ops.ef_mix(*map(jnp.asarray, (w, p, s, u)))
    _assert_y(y, want_y)
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(want_r))
    assert ops.launch_counts()["ef_mix"] == 0  # CPU: the plain version


@pytest.mark.parametrize("n,d", [(5, 1031), (8, 300), (13, 517), (3, 77)])
def test_ef_mix_sparse_plain_matches_reference(n, d):
    graph, w, p, s, u, _ = _kernel_inputs(n, d, seed=3 * n + d)
    y, r = ops.make_sparse_ef_mix(topo.Graph(graph.adjacency))(
        *map(torch.from_numpy, (w, p, s, u)))
    want_y, want_r = ref_ops.make_sparse_ef_mix_pallas(graph)(
        *map(jnp.asarray, (w, p, s, u)))
    _assert_y(y, want_y)
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(want_r))
    assert ops.launch_counts()["ef_mix_sparse"] == 0


@pytest.mark.parametrize("n,d", KERNEL_SHAPES)
def test_quant_mix_plain_matches_reference(n, d):
    _, w, p, _, u, noise = _kernel_inputs(n, d, seed=5 * n + d)
    scale = np.asarray(ref_compress.Int8Compressor.row_scale(jnp.asarray(u)))
    y, q = ops.quant_mix(*map(torch.from_numpy, (w, u, noise, p, scale)))
    want_y, want_q = ref_ops.quant_mix(*map(jnp.asarray,
                                            (w, u, noise, p, scale)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    _assert_y(y, want_y)
    assert ops.launch_counts()["quant_mix"] == 0


@pytest.mark.parametrize("n,d", KERNEL_SHAPES)
def test_dequant_mix_plain_matches_reference(n, d):
    _, w, p, _, u, noise = _kernel_inputs(n, d, seed=7 * n + d)
    scale = np.asarray(ref_compress.Int8Compressor.row_scale(jnp.asarray(u)))
    q = np.clip(np.floor(u / scale[:, None] + noise), -127, 127).astype(
        np.int8)
    y = ops.dequant_mix(*map(torch.from_numpy, (w, q, scale, p)))
    want = ref_ops.dequant_mix(*map(jnp.asarray, (w, q, scale, p)))
    _assert_y(y, want)
    assert ops.launch_counts()["dequant_mix"] == 0


def test_quant_then_dequant_is_the_codec_and_the_mix():
    """#13's q is the int8 codec's payload, and #13's y is #14's on it."""
    _, w, p, _, u, noise = _kernel_inputs(8, 999, seed=11)
    comp = compress.parse_compress("int8")
    payload = comp.encode(torch.from_numpy(noise), torch.from_numpy(u))
    y, q = ops.quant_mix(torch.from_numpy(w), torch.from_numpy(u),
                         torch.from_numpy(noise), torch.from_numpy(p),
                         payload["scale"])
    assert torch.equal(q, payload["q"])
    assert torch.equal(y, ops.dequant_mix(torch.from_numpy(w), q,
                                          payload["scale"],
                                          torch.from_numpy(p)))


def test_wrappers_reject_other_dtypes_and_shapes():
    w = torch.eye(3)
    p = torch.zeros(3, 8)
    with pytest.raises(TypeError):
        ops.ef_mix(w, p.double(), p, p)
    with pytest.raises(TypeError):
        ops.ef_mix(w, p, p.half(), p)
    with pytest.raises(TypeError):
        ops.dequant_mix(w, torch.zeros(3, 8, dtype=torch.int16),
                        torch.ones(3), p)
    with pytest.raises(TypeError):
        ops.quant_mix(w, p, p, p, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.ef_mix(w, p, p, torch.zeros(3, 9))
    with pytest.raises(ValueError):
        ops.dequant_mix(w, torch.zeros(3, 9, dtype=torch.int8),
                        torch.ones(3), p)
    with pytest.raises(ValueError):
        ops.quant_mix(w, p, p, p, torch.ones(4))


# ---------------------------------------------------------------------------
# The flat engine with a codec
# ---------------------------------------------------------------------------


def _spec_and_start(seed: int = 42):
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    ref_spec = ref_flat.make_flat_spec(shapes)
    flat0 = np.random.default_rng(seed).standard_normal(
        (N, ref_spec.d)).astype(np.float32)
    params1 = flat_lib.params_from_numpy(
        jax.tree.map(np.asarray, ref_spec.unravel(jnp.asarray(flat0[0]))))
    return ref_spec, flat_lib.make_flat_spec(params1), flat0


def _configs(impl: str, compress_spec: str):
    ref_graph, graph = _graphs("ring")
    rcfg = RefFedDecConfig(mixing=RefMixing(ref_graph, scheme="metropolis"),
                           h=H, k=K, gossip_impl=impl,
                           gossip_compress=compress_spec)
    cfg = FedDecConfig(mixing=MixingDistribution(graph, scheme="metropolis"),
                       h=H, k=K, gossip_impl=impl,
                       gossip_compress=compress_spec)
    return rcfg, cfg


def _port_round(cfg, spec, opt, fused, per_step=False):
    eta = torch.tensor([ETA])
    kw = dict(device="cpu", optimizer=opt, fuse_update_mix=fused)
    if per_step:
        step = flat_lib.make_flat_feddec_step(cfg, spec, _torch_grad_fn,
                                              lambda t: eta, **kw)
        return engine.make_loop_round(step)
    return flat_lib.make_flat_feddec_round(cfg, spec, _torch_grad_fn,
                                           lambda t: eta, **kw)


def _u_bound(codec: str, states, k: int) -> float:
    """One rounding step of ``codec`` at the largest |u| = |x + e| of the
    reference's states (see the module docstring)."""
    u = [np.abs(np.asarray(s.flat) + np.asarray(s.residual)) for s in states]
    if codec == "int8":
        return 2.0 * max(a.max() for a in u) / 127.0
    if codec == "bf16":
        return float(2.0 ** (np.floor(np.log2(max(a.max() for a in u))) - 7))
    # top-k: the largest |u| at a row's threshold (rows: the last axis)
    return float(max(np.sort(a, axis=-1)[..., -k].max() for a in u))


def _run_both(impl, fused, opt, codec, rounds=2):
    """One reference round from a fresh start, then ``rounds`` more in both
    packages from the reference's state (its residual included)."""
    ref_spec, spec, flat0 = _spec_and_start()
    rcfg, cfg = _configs(impl, codec)
    ref_opt = None if opt == "sgd" else ref_optim.momentum_sgd()
    port_opt = None if opt == "sgd" else optim.momentum_sgd()
    rstate = ref_flat.FlatFedState(
        flat=jnp.asarray(flat0), step=jnp.asarray(1, jnp.int32),
        opt_state=() if ref_opt is None else jnp.zeros_like(flat0),
        residual=jnp.zeros_like(flat0))
    round_ref = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=fused)
    key = jax.random.key(7)
    batches = _batches(rounds + 1)
    rstate, _ = round_ref(rstate, jax.tree.map(jnp.asarray, batches[0]),
                          key)
    states = [rstate]
    state = flat_lib.flat_state_from_numpy(
        np.asarray(rstate.flat), rstate.step,
        () if ref_opt is None else np.asarray(rstate.opt_state),
        residual=np.asarray(rstate.residual))
    round_fn = _port_round(cfg, spec, port_opt, fused)
    draws = ReplayDraws(key)
    ref_losses, losses = [], []
    for b in batches[1:]:
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, b), key)
        states.append(rstate)
        ref_losses.extend(np.asarray(rmet["loss"]).tolist())
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, draws)
        losses.extend(met["loss"].tolist())
    return states, state, ref_losses, losses, spec.d


def _assert_close_lossy(got: np.ndarray, want: np.ndarray, scale: float,
                        bound: float) -> None:
    err = np.abs(got - want)
    assert (err <= 1e-5 * scale).mean() >= 0.99, \
        f"{(err > 1e-5 * scale).mean():.3%} of elements beyond 1e-5·max|x|"
    assert err.max() <= bound, f"max err {err.max():.3e} > {bound:.3e}"


ENGINE_CELLS = [(impl, fused, opt, codec)
                for codec in CODECS
                for impl in ("dense", "pallas", "sparse")
                for fused in (False, True) for opt in ("sgd", "momentum")]


@pytest.mark.parametrize(
    "impl,fused,opt,codec", ENGINE_CELLS,
    ids=[f"{c}-{i}-{'fused' if f else 'unfused'}-{o}"
         for i, f, o, c in ENGINE_CELLS])
def test_compressed_round_matches_reference(impl, fused, opt, codec):
    states, state, ref_losses, losses, d = _run_both(impl, fused, opt,
                                                     codec)
    rstate = states[-1]
    assert state.step == int(rstate.step) == 1 + 3 * H
    x, rx = state.flat.numpy(), np.asarray(rstate.flat)
    res, rres = state.residual.numpy(), np.asarray(rstate.residual)
    if codec == "identity":
        assert np.max(np.abs(x - rx)) <= TOL
        assert not res.any() and not rres.any()
        if opt != "sgd":
            assert np.max(np.abs(state.opt_state.numpy()
                                 - np.asarray(rstate.opt_state))) <= TOL
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
        return
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    bound = _u_bound(codec, states, compress.parse_compress(codec).k_of(d)
                     if codec.startswith("topk") else 0)
    scale = float(np.abs(rx).max())
    _assert_close_lossy(x, rx, scale, bound)
    _assert_close_lossy(res, rres, scale, bound)
    assert np.abs(rres).max() > 0  # the lossy codec left a residual


def _run_port(impl, fused, opt, codec, per_step=False, seed=3):
    """The port alone, from a fresh start, with its own draws."""
    _, spec, flat0 = _spec_and_start()
    _, cfg = _configs(impl, codec)
    port_opt = None if opt == "sgd" else optim.momentum_sgd()
    state = flat_lib.FlatFedState(
        flat=torch.from_numpy(flat0), step=1,
        opt_state=() if port_opt is None else torch.zeros(N, spec.d),
        residual=compress.init_residual(compress.parse_compress(codec), N,
                                        spec.d, torch.float32))
    round_fn = _port_round(cfg, spec, port_opt, fused, per_step=per_step)
    draws = Draws(seed, "cpu")
    losses = []
    for b in _batches(2):
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, draws)
        losses.extend(met["loss"].tolist())
    return state, losses


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_identity_is_the_uncompressed_run(impl, fused, opt):
    """identity: s = u = p, so y = W p + diag·0 and the residual stays 0:
    the uncompressed trajectory to 0.0."""
    a, la = _run_port(impl, fused, opt, "identity")
    b, lb = _run_port(impl, fused, opt, "none")
    assert la == lb and torch.equal(a.flat, b.flat)
    assert b.residual == () and not a.residual.any()
    if opt != "sgd":
        assert torch.equal(a.opt_state, b.opt_state)


@pytest.mark.parametrize("codec", ["bf16", "int8", "topk:0.25"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_fused_matches_unfused_under_a_codec(codec, impl):
    """The fused EF op (#9/#11) and the unfused ef_gossip (the mix, then
    the diagonal term; #14 on int8 × pallas) share the codec: the same
    payloads, the mix within f32 noise."""
    a, la = _run_port(impl, True, "momentum", codec)
    b, lb = _run_port(impl, False, "momentum", codec)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    torch.testing.assert_close(a.flat, b.flat, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a.residual, b.residual, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("codec", ["int8", "topk:0.25"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sparse_matches_dense_under_a_codec(codec, fused):
    a, _ = _run_port("dense", fused, "sgd", codec)
    b, _ = _run_port("sparse", fused, "sgd", codec)
    torch.testing.assert_close(a.flat, b.flat, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a.residual, b.residual, atol=1e-5, rtol=1e-5)


def test_per_step_executor_equals_round_under_a_codec():
    a, la = _run_port("sparse", True, "momentum", "int8", per_step=True)
    b, lb = _run_port("sparse", True, "momentum", "int8")
    assert la == lb and torch.equal(a.flat, b.flat)
    assert torch.equal(a.residual, b.residual)


def test_impl_none_skips_compression():
    """W = I exchanges nothing: the codec composes to a no-op, no noise is
    drawn, and a residual, if carried, passes through unchanged."""
    a, la = _run_port("none", False, "sgd", "none")
    _, spec, flat0 = _spec_and_start()
    _, cfg = _configs("none", "int8")
    ops_ = flat_lib._flat_ops(cfg, spec, _torch_grad_fn, lambda t: None,
                              None, None, "cpu", fuse_update_mix=True)
    assert ops_.ef_gossip is None and ops_.fused_update_gossip is None
    b, lb = _run_port("none", False, "sgd", "int8")
    assert la == lb and torch.equal(a.flat, b.flat)
    assert not b.residual.any()  # carried from init, never touched
    assert a.residual == ()


def test_state_from_numpy_carries_the_residual():
    rng = np.random.default_rng(0)
    flat, res = rng.standard_normal((2, 3, 5)).astype(np.float32)
    state = flat_lib.flat_state_from_numpy(flat, np.int32(4), residual=res)
    assert state.step == 4 and state.opt_state == ()
    np.testing.assert_array_equal(state.residual.numpy(), res)
    assert flat_lib.flat_state_from_numpy(flat, 1).residual == ()
    spec = flat_lib.make_flat_spec({"b": torch.zeros(5)})
    assert flat_lib.init_flat_state(spec, {"b": torch.zeros(5)}, 3,
                                    compress="int8").residual.shape == (3, 5)
    assert flat_lib.init_flat_state(spec, {"b": torch.zeros(5)},
                                    3).residual == ()


def test_codec_noise_replays_the_reference_keys():
    key = jax.random.key(5)
    draws = ReplayDraws(key)
    key_w = jax.random.split(jax.random.fold_in(key, 4), 3)[0]
    want = np.asarray(ref_codec_noise(key_w, 3, 17))
    np.testing.assert_array_equal(draws.codec_noise(4, 3, 17).numpy(), want)
    own = Draws(0, "cpu").codec_noise(1, 3, 17)
    assert own.shape == (3, 17) and own.dtype == torch.float32
    assert 0.0 <= float(own.min()) and float(own.max()) < 1.0


class _CountingDraws(Draws):
    def __init__(self, seed):
        super().__init__(seed, "cpu")
        self.noise_calls = 0

    def codec_noise(self, t, n, d):
        self.noise_calls += 1
        return super().codec_noise(t, n, d)


@pytest.mark.parametrize("codec", ["identity", "bf16", "topk:0.25", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_only_int8_draws_codec_noise(codec, fused):
    """identity, bf16 and top-k consume exactly the uncompressed run's
    draws, as the reference derives its codec key without a split; int8
    draws its noise once per step."""
    _, spec, flat0 = _spec_and_start()
    _, cfg = _configs("pallas", codec)
    state = flat_lib.FlatFedState(flat=torch.from_numpy(flat0), step=1,
                                  residual=torch.zeros(N, spec.d))
    step = flat_lib.make_flat_feddec_step(
        cfg, spec, _torch_grad_fn, lambda t: torch.tensor([ETA]),
        device="cpu",
        fuse_update_mix=fused)
    probe = _CountingDraws(9)
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1)[0].items()}
    step(state, batch, probe)
    assert probe.noise_calls == (codec == "int8")


def test_sweep_lattice_with_a_codec_is_not_ported():
    """A lattice takes a codec that its runs share, a FedAvg member
    included, and rejects a mixed one with the reference's message
    (repro/core/sweep.py:141-143)."""
    rcfg, cfg = _configs("pallas", "int8")
    ref_none, none_cfg = _configs("none", "int8")
    plan = sweep_lib.make_sweep_plan([cfg, none_cfg])
    assert plan.gossip_compress == "int8" and plan.gossip_impl == "pallas"
    ref_plain, plain = _configs("pallas", "none")
    with pytest.raises(ValueError) as ref_err:
        ref_sweep.make_sweep_plan([ref_plain, ref_none])
    with pytest.raises(ValueError) as err:
        sweep_lib.make_sweep_plan([plain, none_cfg])
    assert str(err.value) == str(ref_err.value) == (
        "gossip_compress must be shared across the lattice")


def test_plain_ef_mix_rounds_the_reference_way():
    """(W s)→p.dtype first, then + diag·(p − s), each op rounded once."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.random((4, 4), dtype=np.float32))
    p, s, u = (torch.from_numpy(rng.standard_normal((4, 33)).astype(
        np.float32)) for _ in range(3))
    y, r = ref.ef_mix(w, p, s, u)
    want = torch.matmul(w, s) + torch.diagonal(w)[:, None] * (p - s)
    assert torch.equal(y, want) and torch.equal(r, u - s)
