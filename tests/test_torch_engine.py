"""The port's flat engine against the JAX package's, under replayed draws.

Both engines run the same small quadratic problem (written once in JAX,
once in torch) from the same numpy start, for 2 rounds of H = 3 steps,
over gossip impl {dense, pallas, sparse} × fused update+mix {off, on} ×
{sgd, momentum}, plus link-failure cells.  The port's randomness is
replaced by a replay of the reference's: per-step keys
``split(fold_in(step_key, t), 3)`` give W^t's uniforms, the int8 codec's
noise (tests/test_torch_compress.py) and the server's K draws.  On the CPU the reference runs its Pallas kernels in interpret
mode and the port its plain versions.  Tolerance: 1e-5 max abs on the
flat buffer and the momentum slot (f32, short horizon).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import flat as ref_flat
from repro.core import gossip as ref_gossip
from repro.core import server as ref_server
from repro.core import topology as ref_topo
from repro.core.flat import _fuse_kind as ref_fuse_kind
from repro.core.mixing import MixingDistribution as RefMixing
from repro_torch import optim
from repro_torch.core import engine, flat as flat_lib, gossip, server
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.feddec import FedAvgConfig, FedDecConfig
from repro_torch.core.mixing import MixingDistribution

N, H, K, ETA = 5, 3, 2, 0.1
SHAPES = {"b": (211,), "w": {"k": (5, 397)}}   # D = 2196
TOL = 1e-5


class ReplayDraws:
    """The reference's per-step draws, served through the port's Draws
    interface (repro/core/flat.py:441-442, server.py:34-37,
    mixing.py:115-125)."""

    def __init__(self, step_key):
        self.step_key = step_key

    def _keys(self, t):
        return jax.random.split(jax.random.fold_in(self.step_key, t), 3)

    def link_uniforms(self, t, n):
        u = jax.random.uniform(self._keys(t)[0], (n, n))
        return torch.from_numpy(np.array(u))

    def participants(self, t, n, k):
        idx = jax.random.randint(self._keys(t)[2], (k,), 0, n)
        return torch.from_numpy(np.array(idx).astype(np.int64))

    def codec_noise(self, t, n, d):
        """The int8 codec's noise: ``_row_noise(split(fold_in(key_w, 1),
        n), d)`` (repro/core/flat.py:450-451, compress.py:256-257)."""
        return torch.from_numpy(np.array(ref_codec_noise(self._keys(t)[0],
                                                         n, d)))


def ref_codec_noise(key_w, n, d):
    """The reference's int8 rounding noise for step key ``key_w``."""
    from repro.core.compress import _row_noise
    return _row_noise(jax.random.split(jax.random.fold_in(key_w, 1), n), d)


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


def _batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tb": rng.standard_normal((H, N, 211)).astype(np.float32),
             "tw": rng.standard_normal((H, N, 5, 397)).astype(np.float32)}
            for _ in range(rounds)]


def _graphs(kind):
    if kind == "ring":
        g = ref_topo.ring_graph(N, k=2)
    else:  # a star: one hub above the ELL degree bound
        n = 20
        adj = np.zeros((n, n), dtype=bool)
        adj[0, 1:] = adj[1:, 0] = True
        g = ref_topo.Graph(adj)
    return g, topo.Graph(g.adjacency)


def _run_both(impl, fused, opt, p_fail=0.0, per_step=False, rounds=2):
    ref_graph, graph = _graphs("ring")
    rcfg = RefFedDecConfig(mixing=RefMixing(ref_graph, p_fail=p_fail,
                                            scheme="metropolis"),
                           h=H, k=K, gossip_impl=impl)
    cfg = FedDecConfig(mixing=MixingDistribution(graph, p_fail=p_fail,
                                                 scheme="metropolis"),
                       h=H, k=K, gossip_impl=impl)
    ref_opt = {"sgd": None, "momentum": ref_optim.momentum_sgd(),
               "nesterov": ref_optim.momentum_sgd(nesterov=True)}[opt]
    port_opt = {"sgd": None, "momentum": optim.momentum_sgd(),
                "nesterov": optim.momentum_sgd(nesterov=True)}[opt]

    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          SHAPES, is_leaf=lambda s: isinstance(s, tuple))
    ref_spec = ref_flat.make_flat_spec(shapes)
    rng = np.random.default_rng(42)
    flat0 = rng.standard_normal((N, ref_spec.d)).astype(np.float32)
    rstate = ref_flat.FlatFedState(
        flat=jnp.asarray(flat0), step=jnp.asarray(1, jnp.int32),
        opt_state=() if ref_opt is None else jnp.zeros_like(flat0))
    round_ref = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, _ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=fused)

    params1 = flat_lib.params_from_numpy(
        jax.tree.map(np.asarray, ref_spec.unravel(jnp.asarray(flat0[0]))))
    spec = flat_lib.make_flat_spec(params1)
    state = flat_lib.flat_state_from_numpy(
        flat0, 1, () if port_opt is None else np.zeros_like(flat0))
    eta = torch.tensor([ETA])
    kw = dict(device="cpu", optimizer=port_opt, fuse_update_mix=fused)
    step = flat_lib.make_flat_feddec_step(cfg, spec, _torch_grad_fn,
                                          lambda t: eta, **kw)
    round_fn = flat_lib.make_flat_feddec_round(cfg, spec, _torch_grad_fn,
                                               lambda t: eta, **kw)

    key = jax.random.key(7)
    draws = ReplayDraws(key)
    ref_losses, losses = [], []
    for batches in _batches(rounds):
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, batches),
                                 key)
        ref_losses.extend(np.asarray(rmet["loss"]).tolist())
        tb = {k: torch.from_numpy(v) for k, v in batches.items()}
        if per_step:
            for h in range(H):
                state, met = step(state, {k: v[h] for k, v in tb.items()},
                                  draws)
                losses.append(float(met["loss"]))
        else:
            state, met = round_fn(state, tb, draws)
            losses.extend(met["loss"].tolist())
    return rstate, state, ref_losses, losses


CELLS = [(impl, fused, opt) for impl in ("dense", "pallas", "sparse")
         for fused in (False, True) for opt in ("sgd", "momentum")]


@pytest.mark.parametrize("impl,fused,opt", CELLS,
                         ids=[f"{i}-{'fused' if f else 'unfused'}-{o}"
                              for i, f, o in CELLS])
def test_flat_round_matches_reference(impl, fused, opt):
    rstate, state, ref_losses, losses = _run_both(impl, fused, opt)
    assert state.step == int(rstate.step) == 1 + 2 * H
    assert np.max(np.abs(state.flat.numpy() - np.asarray(rstate.flat))) \
        <= TOL
    if opt != "sgd":
        assert np.max(np.abs(state.opt_state.numpy()
                             - np.asarray(rstate.opt_state))) <= TOL
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


@pytest.mark.parametrize("impl,fused,opt", [
    ("sparse", True, "nesterov"), ("pallas", False, "sgd"),
    ("dense", True, "momentum")])
def test_link_failures_replay_reference_w(impl, fused, opt):
    rstate, state, _, _ = _run_both(impl, fused, opt, p_fail=0.3)
    assert np.max(np.abs(state.flat.numpy() - np.asarray(rstate.flat))) \
        <= TOL


def test_per_step_executor_equals_round():
    _, a, _, la = _run_both("sparse", True, "momentum", per_step=True,
                            rounds=1)
    _, b, _, lb = _run_both("sparse", True, "momentum", rounds=1)
    assert torch.equal(a.flat, b.flat) and torch.equal(a.opt_state,
                                                       b.opt_state)
    assert la == lb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_link_failure_w_matches_reference_sample(seed):
    graph = ref_topo.ring_graph(7, k=2)
    key = jax.random.key(seed)
    want = np.asarray(RefMixing(graph, p_fail=0.4).sample(key))
    port = MixingDistribution(topo.Graph(graph.adjacency), p_fail=0.4)
    draws = ReplayDraws(None)
    draws._keys = lambda t: (key, None, None)
    got = port.make_sampler("cpu")(draws, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_fixed_w_is_the_reference_matrix():
    graph = ref_topo.ring_graph(8, k=2)
    for scheme in ("laplacian", "metropolis", "max_degree"):
        want = RefMixing(graph, scheme=scheme).fixed_w
        got = MixingDistribution(topo.Graph(graph.adjacency),
                                 scheme=scheme).fixed_w
        np.testing.assert_array_equal(got, want)


def test_server_round_matches_reference():
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((6, 333)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(ref_server.server_round_flat(key, jnp.asarray(flat),
                                                   4))
    draws = ReplayDraws(None)
    draws._keys = lambda t: (None, None, key)
    got = server.server_round_flat(draws, 0, torch.from_numpy(flat.copy()),
                                   4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_server_round_in_column_blocks_matches_one_block(monkeypatch, dtype):
    """A buffer wider than one block (ragged last block) is contracted
    block by block into what one contraction of the whole gives."""
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.standard_normal((6, 333))).to(dtype)
    weights = torch.tensor([0.5, 0.0, 0.25, 0.0, 0.25, 0.0])
    want = server.aggregate_and_broadcast_flat(weights, flat.clone())
    monkeypatch.setattr(server, "_SERVER_COLS", 64)
    got = server.aggregate_and_broadcast_flat(weights, flat.clone())
    assert torch.equal(got, want)
    assert torch.equal(got, want[:1].expand_as(want))


@pytest.mark.parametrize("kind", ["ring", "star"])
def test_sparse_gossip_matches_reference_plain_mix(kind):
    ref_graph, graph = _graphs(kind)
    n = graph.n
    rng = np.random.default_rng(5)
    w = RefMixing(ref_graph, p_fail=0.3, scheme="metropolis").sample(
        jax.random.key(1))
    x = rng.standard_normal((n, 250)).astype(np.float32)
    want = ref_gossip.make_sparse_gossip(ref_graph)(w, jnp.asarray(x))
    got = gossip.make_sparse_gossip(graph)(torch.from_numpy(np.array(w)),
                                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_unknown_impl_error_is_the_reference_message():
    graph = ref_topo.ring_graph(4)
    for impl in ("bogus", "permute"):
        with pytest.raises(ValueError) as ref_err:
            RefFedDecConfig(mixing=RefMixing(graph), gossip_impl=impl)
        with pytest.raises(ValueError) as err:
            FedDecConfig(mixing=MixingDistribution(topo.Graph(
                graph.adjacency)), gossip_impl=impl)
        assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("graph_kind", ["ring", "star"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse", "none"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "custom"])
@pytest.mark.parametrize("custom_gossip", [False, True])
def test_fuse_kind_fallbacks_match_reference(graph_kind, impl, opt,
                                             custom_gossip):
    ref_graph, graph = _graphs(graph_kind)
    rcfg = RefFedDecConfig(mixing=RefMixing(ref_graph), gossip_impl=impl)
    cfg = FedDecConfig(mixing=MixingDistribution(graph), gossip_impl=impl)
    ref_opt = {"sgd": None, "momentum": ref_optim.momentum_sgd(),
               "custom": ref_optim.adamw()}[opt]
    port_opt = {"sgd": None, "momentum": optim.momentum_sgd(),
                "custom": optim.Optimizer(lambda p: (),
                                          lambda p, g, s, lr: (p, s))}[opt]
    assert flat_lib._fuse_kind(cfg, port_opt, custom_gossip) == \
        ref_fuse_kind(rcfg, ref_opt, custom_gossip)


def test_resolve_gossip_dispatch():
    _, graph = _graphs("ring")
    cfg = FedDecConfig(mixing=MixingDistribution(graph), gossip_impl="pallas")
    from repro_torch.kernels import ops
    assert engine.resolve_gossip(cfg) is ops.gossip_mix
    x = torch.randn(N, 10)
    assert engine.resolve_gossip(FedAvgConfig(N))(None, x) is x
    assert engine.resolve_gossip(cfg, "tree") is ops.gossip_mix_tree
    with pytest.raises(ValueError, match="not ported"):
        engine.resolve_gossip(cfg, "sharded")


def test_draws_are_deterministic_per_seed():
    a, b = Draws(9, "cpu"), Draws(9, "cpu")
    assert torch.equal(a.link_uniforms(1, 6), b.link_uniforms(1, 6))
    pa, pb = a.participants(1, 6, 4), b.participants(1, 6, 4)
    assert torch.equal(pa, pb) and pa.dtype == torch.int64
    assert 0 <= int(pa.min()) and int(pa.max()) < 6


def test_executors_donate_the_input_state():
    """The reference's executors donate their input (donate=True); the
    port's update it in place, so no caller keeps the old buffers alive."""
    _, graph = _graphs("ring")
    cfg = FedDecConfig(mixing=MixingDistribution(graph), h=H, k=K)
    spec = flat_lib.make_flat_spec({"b": torch.zeros(4)})
    state = flat_lib.FlatFedState(flat=torch.ones(N, 4), step=1)
    old = state.flat
    step = flat_lib.make_flat_feddec_step(
        cfg, spec, engine.value_and_grad(lambda p, b: p["b"].sum()),
        lambda t: torch.tensor([0.1]), device="cpu")
    new, _ = step(state, {"x": torch.zeros(N, 1)}, Draws(0, "cpu"))
    assert new is state and state.step == 2 and state.flat is not old
    torch.testing.assert_close(state.flat, torch.full((N, 4), 0.9))
