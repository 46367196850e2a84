"""The port's tree engine (core/feddec.py, core/fedavg.py) against the JAX
package's, under replayed draws, and the reference's contract tests of
that engine mirrored on the port.

Both tree engines run a quadratic over a nested dict whose insertion
order is not its sorted order (the leaf index of the per-leaf codec
noise is the sorted position, as ``jax.tree.flatten`` gives it), with
leaves 1, 3, 211 and 5 × 97 wide, from the same numpy start, for 2
rounds of H = 3: over gossip impl {dense, pallas, sparse, none} ×
optimizer {sgd, momentum, adamw} × server {on, off} × W {fixed, link
failures p 0.1}.  The replay: step t uses ``split(fold_in(step_key, t),
3)`` for W^t's uniforms and the server's K draws, and leaf l's int8 noise
is ``_row_noise(split(fold_in(fold_in(key_w, 1), l), n), d_l)``
(repro/core/compress.py:304-314).  On the CPU the port's 'pallas' runs
kernel #1's plain version leaf by leaf; it is held to the reference's
'dense' tree path (which tests/test_gossip_impls.py:70 holds equal to its
Pallas one), since the reference's interpret-mode kernel per leaf per
step would dominate the file's time.

Tolerances: parameters within 1e-5·max|x| and the momentum slot and
adamw's m within 1e-6·max|m| (f32, short horizon; the two frameworks sum
the mix and the gradient in other orders), losses 1e-5 relative, adamw's
count exact.  The tree EF gossip from the same payload and noise: y
within 1e-5·max|y|, the residual likewise.  A compressed engine round
holds the lossy rule of tests/test_torch_compress.py (losses 1e-4
relative, 99% of elements within 1e-5·max|x|, every one within one
rounding step).  The port's uncompressed tree and flat engines end on
the same parameters: exactly under 'sparse' and 'none'; under 'dense'
and 'pallas' the CPU's matrix product sums a narrow leaf (1 or 3 wide) in
another order than the whole buffer, and the runs end 5.96e-8 apart (one
rounding of an element near 0.5, held at 1e-6·max|x|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import compress as ref_compress
from repro.core import feddec as ref_feddec
from repro.core import flat as ref_flat
from repro.core import gossip as ref_gossip
from repro.core import server as ref_server
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro_torch import optim
from repro_torch.core import compress, engine, feddec, fedavg
from repro_torch.core import flat as flat_lib
from repro_torch.core import gossip, server, theory
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.kernels import ops
from repro_torch.tree import leaves
from test_torch_engine import ReplayDraws

N, H, K, ETA = 5, 3, 2, 0.1
# insertion order ≠ sorted order; widths 1, 3, 211 and 485
SHAPES = {"w": {"k": (5, 97), "a": (3,)}, "b": (211,), "s": (1,)}
SCALE = {"b": 1.0, "k": 2.0, "a": 3.0, "s": 0.5}
TOL = 1e-5
M_TOL = 1e-6


class ReplayTreeDraws(ReplayDraws):
    """The reference tree engine's draws: ReplayDraws' W and server draws,
    and the per-leaf int8 noise of make_tree_ef_gossip."""

    def codec_noise(self, t, n, d, leaf=None):
        key_c = jax.random.fold_in(self._keys(t)[0], 1)
        keys = jax.random.split(jax.random.fold_in(key_c, leaf), n)
        return torch.from_numpy(np.array(ref_compress._row_noise(keys, d)))


def _terms(params, batch):
    return [(SCALE["b"], params["b"], batch["tb"]),
            (SCALE["k"], params["w"]["k"], batch["tk"]),
            (SCALE["a"], params["w"]["a"], batch["ta"]),
            (SCALE["s"], params["s"], batch["ts"])]


def _jax_loss(params, batch):
    return 0.5 * sum(jnp.sum(jnp.square(c * p - t))
                     for c, p, t in _terms(params, batch))


def _torch_loss(params, batch):
    return 0.5 * sum(torch.sum(torch.square(c * p - t))
                     for c, p, t in _terms(params, batch))


_torch_grad_fn = engine.value_and_grad(_torch_loss)


def _ref_grad_fn(params, batch, key):
    del key
    return jax.value_and_grad(_jax_loss)(params, batch)


def _np_tree(rng, lead, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _np_tree(rng, lead, v) for k, v in shapes.items()}
    return rng.standard_normal(lead + shapes).astype(np.float32)


def _batches(rounds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        t = _np_tree(rng, (H, N))
        out.append({"tb": t["b"], "tk": t["w"]["k"], "ta": t["w"]["a"],
                    "ts": t["s"]})
    return out


def _configs(impl="dense", p_fail=0.0, server_enabled=True,
             compress_spec="none", graph="ring"):
    g = ref_topo.ring_graph(N, k=1) if graph == "ring" \
        else ref_topo.geographic_graph(N, 0.6, seed=3)
    ref_impl = "dense" if impl == "pallas" else impl
    rcfg = ref_feddec.FedDecConfig(
        mixing=RefMixing(g, p_fail=p_fail, scheme="metropolis"), h=H, k=K,
        server_enabled=server_enabled, gossip_impl=ref_impl,
        gossip_compress=compress_spec)
    cfg = feddec.FedDecConfig(
        mixing=MixingDistribution(topo.Graph(g.adjacency), p_fail=p_fail,
                                  scheme="metropolis"), h=H, k=K,
        server_enabled=server_enabled, gossip_impl=impl,
        gossip_compress=compress_spec)
    return rcfg, cfg


def _opts(opt):
    return ({"sgd": None, "momentum": ref_optim.momentum_sgd(),
             "adamw": ref_optim.adamw()}[opt],
            {"sgd": None, "momentum": optim.momentum_sgd(),
             "adamw": optim.adamw()}[opt])


def _start(opt, compress_spec="none", seed=42):
    """(reference FedState, port FedState) of one random stacked start
    (every agent different), the optimizer's zero slots and residual."""
    rng = np.random.default_rng(seed)
    params = _np_tree(rng, (N,))
    ref_opt, _ = _opts(opt)
    ref_params = jax.tree.map(jnp.asarray, params)
    opt_state = () if ref_opt is None else jax.vmap(ref_opt.init)(ref_params)
    residual = ref_compress.init_residual_tree(
        ref_compress.parse_compress(compress_spec), ref_params)
    rstate = ref_feddec.FedState(params=ref_params,
                                 step=jnp.asarray(1, jnp.int32),
                                 opt_state=opt_state, residual=residual)
    state = flat_lib.fedstate_from_numpy(
        params, 1, jax.tree.map(np.asarray, opt_state),
        residual=jax.tree.map(np.asarray, residual))
    return rstate, state


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _run_both(impl, opt, p_fail=0.0, server_enabled=True,
              compress_spec="none", rounds=2, per_step=False):
    """Both tree engines over ``rounds`` rounds of H steps (the port's
    one-step executor per step with ``per_step``)."""
    rcfg, cfg = _configs(impl, p_fail, server_enabled, compress_spec)
    ref_opt, port_opt = _opts(opt)
    rstate, state = _start(opt, compress_spec)
    lr = lambda t: jnp.asarray(ETA, jnp.float32)  # noqa: E731
    if per_step:
        ref_step = ref_feddec.make_feddec_step(rcfg, _ref_grad_fn, lr,
                                               optimizer=ref_opt,
                                               donate=False)
        step = feddec.make_feddec_step(cfg, _torch_grad_fn, lambda t: ETA,
                                       optimizer=port_opt, device="cpu")
    round_ref = ref_feddec.make_feddec_round(rcfg, _ref_grad_fn, lr,
                                             optimizer=ref_opt, donate=False)
    round_fn = feddec.make_feddec_round(cfg, _torch_grad_fn, lambda t: ETA,
                                        optimizer=port_opt, device="cpu")
    key = jax.random.key(7)
    draws = ReplayTreeDraws(key)
    states, ref_losses, losses = [], [], []
    for b in _batches(rounds):
        if per_step:
            for h in range(H):
                rstate, rmet = ref_step(rstate, jax.tree.map(
                    lambda v: jnp.asarray(v[h]), b), key)
                ref_losses.append(float(rmet["loss"]))
                state, met = step(state, {k: torch.from_numpy(v[h])
                                          for k, v in b.items()}, draws)
                losses.append(float(met["loss"]))
        else:
            rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, b),
                                     key)
            ref_losses.extend(np.asarray(rmet["loss"]).tolist())
            state, met = round_fn(state, _torch_batch(b), draws)
            assert met["loss"].shape == met["eta"].shape == (H,)
            losses.extend(met["loss"].tolist())
        states.append(rstate)
    return states, state, ref_losses, losses


def _max_err(port_tree, ref_tree):
    """(max abs difference, max |reference|) over every leaf."""
    pl, rl = leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(pl) == len(rl)
    assert [tuple(p.shape) for p in pl] == [r.shape for r in rl]
    err = max(float(np.abs(p.numpy() - np.asarray(r)).max())
              for p, r in zip(pl, rl))
    return err, max(float(np.abs(np.asarray(r)).max()) for r in rl)


def _assert_tree_close(port_tree, ref_tree, tol):
    err, scale = _max_err(port_tree, ref_tree)
    assert err <= tol * scale, f"{err:.3e} > {tol}·{scale:.3e}"


def _assert_matches(rstate, state, ref_losses, losses, opt):
    assert state.step == int(rstate.step)
    _assert_tree_close(state.params, rstate.params, TOL)
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
    if opt == "momentum":
        _assert_tree_close(state.opt_state, rstate.opt_state, M_TOL)
    elif opt == "adamw":
        _assert_tree_close(state.opt_state["m"], rstate.opt_state["m"],
                           M_TOL)
        _assert_tree_close(state.opt_state["v"], rstate.opt_state["v"],
                           M_TOL)
        np.testing.assert_array_equal(state.opt_state["count"].numpy(),
                                      np.asarray(rstate.opt_state["count"]))
        assert state.opt_state["count"].shape == (N,)


CELLS = [(impl, opt, srv, p_fail)
         for impl in ("dense", "pallas", "sparse", "none")
         for opt in ("sgd", "momentum", "adamw")
         for srv in (True, False) for p_fail in (0.0, 0.1)]


@pytest.mark.parametrize(
    "impl,opt,server_enabled,p_fail", CELLS,
    ids=[f"{i}-{o}-{'server' if s else 'noserver'}-p{p}"
         for i, o, s, p in CELLS])
def test_tree_round_matches_reference(impl, opt, server_enabled, p_fail):
    states, state, ref_losses, losses = _run_both(
        impl, opt, p_fail=p_fail, server_enabled=server_enabled)
    assert state.step == 1 + 2 * H
    _assert_matches(states[-1], state, ref_losses, losses, opt)


@pytest.mark.parametrize("impl,opt,p_fail", [
    ("dense", "momentum", 0.1), ("pallas", "adamw", 0.0),
    ("sparse", "sgd", 0.1), ("none", "adamw", 0.1)])
def test_tree_step_matches_reference(impl, opt, p_fail):
    states, state, ref_losses, losses = _run_both(impl, opt, p_fail=p_fail,
                                                  per_step=True)
    _assert_matches(states[-1], state, ref_losses, losses, opt)


# ---------------------------------------------------------------------------
# Compressed gossip on the tree
# ---------------------------------------------------------------------------


CODECS = ("identity", "bf16", "int8", "topk:0.25")


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("codec", CODECS)
def test_tree_ef_gossip_matches_reference(codec, impl):
    """One leaf-wise EF exchange from the same p, residual and per-leaf
    noise: y and the new residual within 1e-5 of the reference's."""
    rcfg, cfg = _configs(impl, p_fail=0.3)
    rng = np.random.default_rng(4)
    p, res = _np_tree(rng, (N,)), _np_tree(rng, (N,))
    res = jax.tree.map(lambda r: 0.01 * r, res)
    key_w = jax.random.key(3)
    w = np.asarray(rcfg.mixing.sample(key_w))
    ref_fn = ref_compress.make_tree_ef_gossip(
        ref_compress.parse_compress(codec),
        ref_feddec.resolve_tree_gossip(rcfg), N)
    ry, rres = ref_fn(jnp.asarray(w), jax.tree.map(jnp.asarray, p),
                      jax.tree.map(jnp.asarray, res),
                      jax.random.fold_in(key_w, 1))

    class LeafNoise:
        def codec_noise(self, t, n, d, leaf=None):
            keys = jax.random.split(jax.random.fold_in(
                jax.random.fold_in(key_w, 1), leaf), n)
            return torch.from_numpy(np.array(ref_compress._row_noise(keys,
                                                                     d)))

    fn = compress.make_tree_ef_gossip(compress.parse_compress(codec),
                                      feddec.resolve_tree_gossip(cfg), N)
    y, new_res = fn(torch.from_numpy(w.copy()),
                    flat_lib.params_from_numpy(p),
                    flat_lib.params_from_numpy(res), LeafNoise(), 1)
    _assert_tree_close(y, ry, TOL)
    err, scale = _max_err(new_res, rres)
    assert err <= TOL * max(scale, 1e-30)
    if codec == "identity":
        assert max(float(r.abs().max()) for r in leaves(new_res)) == 0.0


def _assert_close_lossy(port_tree, ref_tree, scale, bound):
    err = np.concatenate([
        np.abs(p.numpy() - np.asarray(r)).ravel()
        for p, r in zip(leaves(port_tree), jax.tree.leaves(ref_tree))])
    assert (err <= TOL * scale).mean() >= 0.99
    assert err.max() <= bound


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_compressed_tree_round_matches_reference(codec, impl):
    """Two compressed rounds on both tree engines.  identity: the
    uncompressed tolerances and a zero residual; int8: the lossy rule of
    tests/test_torch_compress.py, one rounding step being twice the
    largest per-leaf-row scale max|u|/127."""
    states, state, ref_losses, losses = _run_both(impl, "sgd",
                                                  compress_spec=codec)
    rstate = states[-1]
    if codec == "identity":
        _assert_matches(rstate, state, ref_losses, losses, "sgd")
        assert all(not r.any() for r in leaves(state.residual))
        return
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    u_max = max(float(np.abs(np.asarray(p) + np.asarray(r)).max())
                for s in states for p, r in zip(
                    jax.tree.leaves(s.params), jax.tree.leaves(s.residual)))
    bound = 2.0 * u_max / 127.0
    _, scale = _max_err(state.params, rstate.params)
    _assert_close_lossy(state.params, rstate.params, scale, bound)
    _assert_close_lossy(state.residual, rstate.residual, scale, bound)
    assert max(float(r.abs().max()) for r in leaves(state.residual)) > 0


# ---------------------------------------------------------------------------
# The tree engine and the flat engine of the port
# ---------------------------------------------------------------------------


def _port_tree_and_flat(impl, opt, p_fail):
    _, cfg = _configs(impl, p_fail)
    _, port_opt = _opts(opt)
    _, state = _start(opt)
    spec = flat_lib.make_flat_spec_from_stacked(state.params)
    fstate = flat_lib.flatten_fedstate(spec, state)
    eta = torch.tensor([ETA])
    tree_round = feddec.make_feddec_round(cfg, _torch_grad_fn,
                                          lambda t: eta, optimizer=port_opt,
                                          device="cpu")
    flat_round = flat_lib.make_flat_feddec_round(
        cfg, spec, _torch_grad_fn, lambda t: eta, device="cpu",
        optimizer=port_opt)
    d_tree, d_flat = Draws(5, "cpu"), Draws(5, "cpu")
    for b in _batches(2):
        state, m_tree = tree_round(state, _torch_batch(b), d_tree)
        fstate, m_flat = flat_round(fstate, _torch_batch(b), d_flat)
        assert torch.equal(m_tree["loss"], m_flat["loss"])
    return spec, state, fstate


@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse", "none"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_uncompressed_tree_and_flat_end_on_the_same_buffer(impl, opt):
    """Same start, same draws: the port's tree and flat engines end on the
    same parameters and optimizer state.  The gradients, the elementwise
    update, the ELL gather and the server's average compute each element
    as the whole-buffer ones do (difference 0.0); the CPU's matrix product
    of 'dense' and of #1's plain version may round an element of a narrow
    leaf once more (seen: 5.96e-8)."""
    spec, state, fstate = _port_tree_and_flat(impl, opt, p_fail=0.1)
    assert state.step == fstate.step == 1 + 2 * H
    back = flat_lib.flatten_fedstate(spec, state)
    pairs = [(back.flat, fstate.flat)] + list(zip(
        leaves(back.opt_state), leaves(fstate.opt_state)))
    for a, b in pairs:
        if impl in ("sparse", "none"):
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_flatten_unflatten_round_trip(opt):
    """FedState → FlatFedState → FedState, and the flat side equal to the
    reference's flatten_fedstate bit for bit: moments keep f32, adamw's
    per-agent count becomes one scalar and comes back as (n,)."""
    rstate, state = _start(opt, "int8")
    state.opt_state = jax.tree.map(lambda v: v + 1, state.opt_state)
    rstate.opt_state = jax.tree.map(lambda v: v + 1, rstate.opt_state)
    spec = flat_lib.make_flat_spec_from_stacked(state.params)
    ref_spec = ref_flat.make_flat_spec_from_stacked(rstate.params)
    assert spec.d == ref_spec.d and spec.dtype == torch.float32
    fstate = flat_lib.flatten_fedstate(spec, state)
    rfstate = ref_flat.flatten_fedstate(ref_spec, rstate)
    np.testing.assert_array_equal(fstate.flat.numpy(),
                                  np.asarray(rfstate.flat))
    np.testing.assert_array_equal(fstate.residual.numpy(),
                                  np.asarray(rfstate.residual))
    flat_opt, ref_flat_opt = leaves(fstate.opt_state), \
        jax.tree.leaves(rfstate.opt_state)
    assert len(flat_opt) == len(ref_flat_opt)
    for a, b in zip(flat_opt, ref_flat_opt):
        assert a.shape == b.shape and a.dtype == torch.from_numpy(
            np.array(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if opt == "adamw":
        assert fstate.opt_state["count"].shape == ()
    back = flat_lib.unflatten_fedstate(spec, fstate)
    rback = ref_flat.unflatten_fedstate(ref_spec, rfstate)
    for port, ref in ((back.params, rback.params),
                      (back.opt_state, rback.opt_state),
                      (back.residual, rback.residual)):
        pl, rl = leaves(port), jax.tree.leaves(ref)
        assert len(pl) == len(rl)
        for a, b in zip(pl, rl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(leaves(back.params), leaves(state.params)):
        assert torch.equal(a, b)


def test_tree_pallas_launches_kernel_one_per_leaf_and_none_on_the_cpu():
    """The tree 'pallas' path goes through ops.gossip_mix once per leaf;
    on the CPU the wrapper runs the plain version and counts nothing."""
    calls = []
    real = ops._gossip

    def spy(fn, ndim, w, x):
        calls.append((fn.__name__, tuple(x.shape)))
        return real(fn, ndim, w, x)

    ops.reset_launch_counts()
    try:
        ops._gossip = spy
        _, cfg = _configs("pallas")
        _, state = _start("sgd")
        step = feddec.make_feddec_step(cfg, _torch_grad_fn, lambda t: ETA,
                                       device="cpu")
        step(state, {k: torch.from_numpy(v[0]) for k, v in
                     _batches(1)[0].items()}, Draws(0, "cpu"))
    finally:
        ops._gossip = real
    assert calls == [("gossip_mix", (N, d)) for d in (211, 1, 3, 485)]
    assert sum(ops.launch_counts().values()) == 0


def test_server_broadcast_writes_real_storage():
    x = {"a": torch.randn(4, 3, 2), "b": torch.randn(4)}
    out = server.aggregate_and_broadcast(torch.full((4,), 0.25), x)
    for leaf in leaves(out):
        assert leaf.is_contiguous() and leaf.stride()[0] != 0
        assert torch.allclose(leaf, leaf[:1].expand_as(leaf))
    state = feddec.init_state({"a": torch.ones(2)}, 3)
    assert state.params["a"].stride() == (2, 1)


def test_fedavg_config_stays_importable_from_feddec():
    assert feddec.FedAvgConfig is fedavg.FedAvgConfig
    cfg = feddec.FedAvgConfig(4, h=3, k=2)
    assert cfg.gossip_impl == "none" and cfg.n_agents == 4


def test_make_loop_round_merges_metrics_fn():
    def step(state, batch, draws):
        return state + 1, {"loss": batch["x"].sum()}

    round_fn = engine.make_loop_round(step, lambda s: {"s": torch.tensor(s)})
    state, m = round_fn(0, {"x": torch.ones(4, 2)}, None)
    assert state == 4 and m["loss"].tolist() == [2.0] * 4
    assert m["s"].tolist() == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# The reference's contract tests of the tree engine, on the port
# (tests/test_feddec.py, test_fused_round.py, test_gossip_server.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    return linreg.make_problem(n=10, seed=0, c_base=1.5)


def _setup(problem, h=10, k=2, r=0.6, p_fail=0.0, impl="dense",
           server_enabled=True):
    g = topo.geographic_graph(problem.n, r, seed=3)
    md = MixingDistribution(g, p_fail=p_fail,
                            scheme="metropolis" if p_fail else "laplacian")
    cfg = feddec.FedDecConfig(mixing=md, h=h, k=k, gossip_impl=impl,
                              server_enabled=server_enabled)
    lr = theory.paper_stepsize(problem.mu,
                               theory.gamma(problem.l_smooth, problem.mu, h))
    return cfg, lr, linreg.make_grad_fn(problem.m_rows)


def _init(problem, optimizer=None):
    return feddec.init_state({"z": torch.zeros(problem.d)}, problem.n,
                             optimizer=optimizer)


def _minibatches(problem, steps, seed):
    rng = np.random.default_rng(seed)
    per_step = [linreg.sample_minibatch(problem, torch.from_numpy(
        rng.integers(0, problem.m_rows, (problem.n, 1))), torch.float32)
        for _ in range(steps)]
    return {k: torch.stack([b[k] for b in per_step]) for k in per_step[0]}


def _run(step, problem, t_steps, seed=0, state=None):
    state = _init(problem) if state is None else state
    batches = _minibatches(problem, t_steps, seed)
    draws = Draws(seed + 99, "cpu")
    metrics = None
    for t in range(t_steps):
        state, metrics = step(state, {k: v[t] for k, v in batches.items()},
                              draws)
    return state, metrics


def _subopt(problem, state):
    return float(problem.suboptimality(state.params["z"].double()))


def _consensus(state):
    z = state.params["z"]
    return torch.allclose(z, z[:1].expand_as(z), atol=1e-5, rtol=0)


class TestFedDecStep:
    def test_state_shapes_and_finite(self, problem):
        cfg, lr, grad_fn = _setup(problem)
        state, metrics = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                      device="cpu"),
                              problem, 5)
        assert state.params["z"].shape == (problem.n, problem.d)
        assert state.step == 6
        assert torch.isfinite(state.params["z"]).all()
        assert np.isfinite(float(metrics["loss"]))

    def test_server_round_consensus(self, problem):
        cfg, lr, grad_fn = _setup(problem, h=5)
        state, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                device="cpu"), problem,
                        4)   # t: 1→5, server at t+1=5
        assert _consensus(state)

    def test_no_consensus_between_rounds(self, problem):
        cfg, lr, grad_fn = _setup(problem, h=100)
        state, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                device="cpu"), problem,
                        6)
        z = state.params["z"]
        assert not torch.allclose(z[0], z[1], atol=1e-8, rtol=0)

    def test_server_disabled(self, problem):
        cfg, lr, grad_fn = _setup(problem, h=5, server_enabled=False)
        state, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                device="cpu"), problem,
                        10)
        assert torch.isfinite(state.params["z"]).all()
        assert not _consensus(state)


class TestConvergence:
    def test_feddec_converges(self, problem):
        cfg, lr, grad_fn = _setup(problem)
        sub0 = _subopt(problem, _init(problem))
        state, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                device="cpu"), problem,
                        800)
        assert _subopt(problem, state) < 0.05 * sub0

    def test_feddec_beats_fedavg_large_h(self, problem):
        h = 50
        cfg, lr, grad_fn = _setup(problem, h=h)
        sd, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                             device="cpu"), problem,
                     600, seed=1)
        sa, _ = _run(fedavg.make_fedavg_step(problem.n, grad_fn, lr, h=h,
                                             k=2, device="cpu"),
                     problem, 600, seed=1)
        assert _subopt(problem, sd) < _subopt(problem, sa)

    def test_link_failures_still_converge(self, problem):
        cfg, lr, grad_fn = _setup(problem, p_fail=0.5)
        sub0 = _subopt(problem, _init(problem))
        state, _ = _run(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                device="cpu"), problem,
                        800)
        assert _subopt(problem, state) < 0.1 * sub0


T_RUN = 9


def _fused_setup(problem, **kw):
    return _setup(problem, h=4, **kw)


def _sequential(step, problem, batches, state, draws):
    losses, etas = [], []
    for t in range(T_RUN):
        state, m = step(state, {k: v[t] for k, v in batches.items()}, draws)
        losses.append(float(m["loss"]))
        etas.append(float(m["eta"]))
    return state, np.asarray(losses), np.asarray(etas)


class TestRoundEquivalence:
    @pytest.fixture(scope="class")
    def problem8(self):
        return linreg.make_problem(n=8, seed=0, c_base=1.3)

    @pytest.mark.parametrize("impl", ["dense", "none"])
    @pytest.mark.parametrize("server_enabled", [True, False])
    def test_round_matches_sequential_steps(self, problem8, impl,
                                            server_enabled):
        cfg, lr, grad_fn = _fused_setup(problem8, impl=impl,
                                        server_enabled=server_enabled)
        batches = _minibatches(problem8, T_RUN, 11)
        s_seq, losses, etas = _sequential(
            feddec.make_feddec_step(cfg, grad_fn, lr, device="cpu"),
            problem8, batches,
            _init(problem8), Draws(5, "cpu"))
        s_round, m = feddec.make_feddec_round(cfg, grad_fn, lr, device="cpu")(
            _init(problem8), batches, Draws(5, "cpu"))
        assert torch.equal(s_round.params["z"], s_seq.params["z"])
        np.testing.assert_array_equal(m["loss"].numpy(), losses)
        np.testing.assert_allclose(m["eta"].numpy(), etas, rtol=1e-6)
        assert s_round.step == s_seq.step == T_RUN + 1

    def test_time_varying_topology(self, problem8):
        cfg, lr, grad_fn = _fused_setup(problem8, p_fail=0.4)
        batches = _minibatches(problem8, T_RUN, 11)
        s_seq, _, _ = _sequential(feddec.make_feddec_step(cfg, grad_fn, lr,
                                                          device="cpu"),
                                  problem8, batches, _init(problem8),
                                  Draws(9, "cpu"))
        s_round, _ = feddec.make_feddec_round(cfg, grad_fn, lr, device="cpu")(
            _init(problem8), batches, Draws(9, "cpu"))
        assert torch.equal(s_round.params["z"], s_seq.params["z"])
        cfg0, _, _ = _fused_setup(problem8)
        s0, _ = feddec.make_feddec_round(cfg0, grad_fn, lr, device="cpu")(
            _init(problem8), batches, Draws(9, "cpu"))
        assert not torch.allclose(s_round.params["z"], s0.params["z"],
                                  atol=1e-8, rtol=0)

    def test_fedavg_round_matches_steps(self, problem8):
        _, lr, grad_fn = _fused_setup(problem8)
        batches = _minibatches(problem8, T_RUN, 13)
        s_seq, losses, _ = _sequential(
            fedavg.make_fedavg_step(problem8.n, grad_fn, lr, h=4, k=2,
                                    device="cpu"),
            problem8, batches, _init(problem8), Draws(13, "cpu"))
        s_round, m = fedavg.make_fedavg_round(problem8.n, grad_fn, lr, h=4,
                                              k=2, device="cpu")(
            _init(problem8), batches, Draws(13, "cpu"))
        assert torch.equal(s_round.params["z"], s_seq.params["z"])
        np.testing.assert_array_equal(m["loss"].numpy(), losses)

    def test_fedavg_flat_round_matches_tree_round(self, problem8):
        _, lr, grad_fn = _fused_setup(problem8)
        batches = _minibatches(problem8, T_RUN, 13)
        s_tree, _ = fedavg.make_fedavg_round(problem8.n, grad_fn, lr, h=4,
                                             k=2, device="cpu")(
            _init(problem8), batches, Draws(13, "cpu"))
        spec = flat_lib.make_flat_spec({"z": torch.zeros(problem8.d)})
        fstate = flat_lib.init_flat_state(spec, {"z": torch.zeros(
            problem8.d)}, problem8.n)
        s_flat, _ = fedavg.make_fedavg_flat_round(
            problem8.n, spec, grad_fn,
            lambda t: torch.tensor([lr(t)], dtype=torch.float32), h=4, k=2,
            device="cpu")(fstate, batches, Draws(13, "cpu"))
        assert torch.equal(s_flat.flat, s_tree.params["z"])

    @pytest.mark.parametrize("opt", ["momentum", "adamw"])
    def test_optimizer_state_carried(self, problem8, opt):
        cfg, lr, grad_fn = _fused_setup(problem8)
        _, port_opt = _opts(opt)
        batches = _minibatches(problem8, T_RUN, 17)
        s_seq, _, _ = _sequential(
            feddec.make_feddec_step(cfg, grad_fn, lr, optimizer=port_opt,
                                    device="cpu"),
            problem8, batches, _init(problem8, port_opt), Draws(17, "cpu"))
        s_round, _ = feddec.make_feddec_round(cfg, grad_fn, lr,
                                              optimizer=port_opt,
                                              device="cpu")(
            _init(problem8, port_opt), batches, Draws(17, "cpu"))
        assert torch.equal(s_round.params["z"], s_seq.params["z"])
        for a, b in zip(leaves(s_round.opt_state), leaves(s_seq.opt_state)):
            assert torch.equal(a, b)
        if opt == "adamw":
            assert s_round.opt_state["count"].tolist() == [T_RUN] * 8


class TestRoundContract:
    def test_metrics_stacked_to_h(self, problem):
        cfg, lr, grad_fn = _fused_setup(problem)
        _, m = feddec.make_feddec_round(cfg, grad_fn, lr, device="cpu")(
            _init(problem), _minibatches(problem, 6, 0), Draws(0, "cpu"))
        assert m["loss"].shape == m["eta"].shape == (6,)

    def test_metrics_fn_hook(self, problem):
        cfg, lr, grad_fn = _fused_setup(problem)
        round_fn = feddec.make_feddec_round(
            cfg, grad_fn, lr, device="cpu", metrics_fn=lambda s: {
                "subopt": problem.suboptimality(s.params["z"].double())})
        _, m = round_fn(_init(problem), _minibatches(problem, 5, 0),
                        Draws(0, "cpu"))
        assert m["subopt"].shape == (5,)
        assert torch.isfinite(m["subopt"]).all()

    def test_server_consensus_inside_round(self, problem):
        cfg, lr, grad_fn = _fused_setup(problem)     # h=4, server at t+1=4
        state, _ = feddec.make_feddec_round(cfg, grad_fn, lr, device="cpu")(
            _init(problem), _minibatches(problem, 3, 2), Draws(2, "cpu"))
        assert _consensus(state)

    def test_donation_round_over_round(self, problem):
        """The state passed in is donated: updated in place and returned;
        a round's output feeds the next call."""
        cfg, lr, grad_fn = _fused_setup(problem)
        round_fn = feddec.make_feddec_round(cfg, grad_fn, lr, device="cpu")
        state = _init(problem)
        draws = Draws(3, "cpu")
        for r in range(3):
            out, _ = round_fn(state, _minibatches(problem, 4, r), draws)
            assert out is state
        assert state.step == 13 and torch.isfinite(state.params["z"]).all()


def _stacked_tree(rng, n, shapes=((4,), (2, 3))):
    return {f"w{i}": torch.from_numpy(rng.standard_normal((n,) + s).astype(
        np.float32)) for i, s in enumerate(shapes)}


class TestDenseGossip:
    @pytest.mark.parametrize("seed,p_fail", [(0, 0.0), (3, 0.4), (7, 0.8)])
    def test_mean_preservation(self, seed, p_fail):
        g = topo.geographic_graph(10, 0.6, seed=1)
        w = MixingDistribution(g, p_fail=p_fail, scheme="metropolis"
                               ).make_sampler("cpu")(Draws(seed, "cpu"), 1)
        x = _stacked_tree(np.random.default_rng(seed + 1), 10)
        y = gossip.gossip_mix_dense(w, x)
        for k in x:
            torch.testing.assert_close(y[k].mean(0), x[k].mean(0),
                                       atol=1e-5, rtol=0)

    def test_consensus_contraction(self):
        """‖X − X̄‖² shrinks by ≈ |λ₂|² per fixed-W gossip (Lemma 3)."""
        g = topo.geographic_graph(16, 0.6, seed=2)
        w = torch.tensor(topo.laplacian_weights(g), dtype=torch.float32)
        lam2 = topo.lambda2(w.numpy())
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (16, 32)).astype(np.float32))

        def cons_err(z):
            return float(((z - z.mean(0)) ** 2).sum())

        assert cons_err(gossip.gossip_mix_dense(w, x)) <= \
            lam2 ** 2 * cons_err(x) + 1e-4

    @pytest.mark.parametrize("mix", ["dense", "pallas", "sparse"])
    def test_identity_w_noop(self, mix):
        x = _stacked_tree(np.random.default_rng(0), 6)
        fn = {"dense": gossip.gossip_mix_dense, "pallas": ops.gossip_mix_tree,
              "sparse": gossip.make_sparse_gossip_tree(topo.ring_graph(6))
              }[mix]
        y = fn(torch.eye(6), x)
        for k in x:
            torch.testing.assert_close(y[k], x[k], atol=1e-6, rtol=0)

    @pytest.mark.parametrize("graph", ["ring", "star"])
    def test_tree_mixes_agree_with_the_reference(self, graph):
        """dense / pallas / sparse (ELL on the ring, CSR on a star above
        ELL_MAX_DEG) leaf by leaf against the reference's tree mixes."""
        if graph == "ring":
            g = ref_topo.ring_graph(20, k=2)
        else:
            adj = np.zeros((20, 20), dtype=bool)
            adj[0, 1:] = adj[1:, 0] = True
            g = ref_topo.Graph(adj)
        w = np.asarray(RefMixing(g, scheme="metropolis").sample(
            jax.random.key(0)))
        x = _np_tree(np.random.default_rng(2), (20,))
        want = ref_gossip.gossip_mix_dense(jnp.asarray(w), jax.tree.map(
            jnp.asarray, x))
        ref_sparse = ref_gossip.make_sparse_gossip_tree(g)(
            jnp.asarray(w), jax.tree.map(jnp.asarray, x))
        tx = flat_lib.params_from_numpy(x)
        tw = torch.from_numpy(w.copy())
        for got in (gossip.gossip_mix_dense(tw, tx),
                    ops.gossip_mix_tree(tw, tx)):
            _assert_tree_close(got, want, 1e-6)
        _assert_tree_close(gossip.make_sparse_gossip_tree(
            topo.Graph(g.adjacency))(tw, tx), ref_sparse, 1e-6)


class TestServer:
    def test_counts_sum_to_k(self):
        c = server.sample_participants(Draws(0, "cpu"), 1, 20, 7)
        assert int(c.sum()) == 7

    def test_broadcast_equalises(self):
        x = _stacked_tree(np.random.default_rng(1), 8)
        out = server.server_round(Draws(2, "cpu"), 1, x, k=3)
        for k in out:
            assert torch.equal(out[k], out[k][:1].expand_as(out[k]))

    def test_unbiasedness_eq7(self):
        """E_{S_t}[z̄] = x̄ over many samplings (paper eq. (7))."""
        n, k = 10, 3
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (n, 5)).astype(np.float32))
        draws = Draws(4, "cpu")
        zb = torch.stack([
            server.participant_weights(server.sample_participants(
                draws, t, n, k), k) @ x for t in range(4000)]).mean(0)
        torch.testing.assert_close(zb, x.mean(0), atol=0.05, rtol=0)

    def test_full_participation_exact_mean(self):
        x = _stacked_tree(np.random.default_rng(5), 4)
        means = {k: v.mean(0) for k, v in x.items()}
        out = server.aggregate_and_broadcast(torch.full((4,), 0.25), x)
        for k in x:
            torch.testing.assert_close(out[k][0], means[k], atol=1e-6,
                                       rtol=0)

    def test_tree_server_matches_reference(self):
        x = _np_tree(np.random.default_rng(6), (N,))
        key = jax.random.key(8)
        want = ref_server.server_round(key, jax.tree.map(jnp.asarray, x), K)

        class KeyDraws:   # the reference's sample_participants on ``key``
            def participants(self, t, n, k):
                return torch.from_numpy(np.array(jax.random.randint(
                    key, (k,), 0, n)).astype(np.int64))

        got = server.server_round(KeyDraws(), 0,
                                  flat_lib.params_from_numpy(x), K)
        _assert_tree_close(got, want, 1e-6)
