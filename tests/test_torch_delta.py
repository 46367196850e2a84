"""The port's delta parameterization (repro_torch.core.delta) against the
JAX package's (repro.core.delta), mirroring tests/test_delta.py.

Spec parsing, the byte model (held to the reference's jax-free mirror
``repro.launch.analysis``), the codecs, the flat engine under ``--delta``
and the host ``DeltaStore``.  Codecs and engines get the same numpy
inputs made from a seed.  Tolerances:

  * ``full`` is lossless: decode(encode(u)) == u bit for bit, over the
    reference's adversarial magnitudes, and a ``delta='full'`` run equals
    the port's own ``delta='none'`` run bit for bit;
  * ``topk:K`` keeps the reference's set (ties to the lower index), so
    the decoded rows equal the reference's bit for bit;
  * ``lowrank:R`` (an SVD in f32 on another LAPACK): decoded rows within
    1e-5·max|u| of the reference's; SVD signs are not unique, so only the
    decoded rows and the residual are compared, never U or V;
  * the flat engine under each codec against the reference's
    ``make_flat_feddec_round`` with ``delta_base``, under the reference's
    replayed draws: flat buffer and residual within 1e-5·max|x|, losses
    1e-5 relative; the low-rank codecs there on deltas of rank 2, and
    lowrank:3 on deltas of flat spectra (an ill-posed truncation) within
    2e-4·max|x|.

The reference's hypothesis properties run here as parametrized cases (a
fixed grid of seeds and magnitudes).  ``TestPopulationIntegration``'s two
tests (the population engine over a ``DeltaStore``) are mirrored in
tests/test_torch_population.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import delta as ref_delta
from repro.core import engine as ref_engine
from repro.core import flat as ref_flat
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.launch import analysis
from repro_torch import optim
from repro_torch.core import delta as delta_lib
from repro_torch.core import engine, feddec, flat as flat_lib
from repro_torch.core import topology as topo
from repro_torch.core.mixing import MixingDistribution
from test_torch_engine import (ReplayDraws, _batches, _ref_grad_fn,
                               _torch_grad_fn, SHAPES, N, H, K, ETA)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5           # × max|x|: f32 engines, other summation order
LOWRANK_TOL = 1e-5   # × max|u|: f32 SVDs on two LAPACKs
# × max|x|: lowrank on deltas of flat spectra, where the truncated
# subspace amplifies the SVDs' rounding (test_lowrank_engine_on_flat_spectra)
LOWRANK_FLAT_TOL = 2e-4

# the reference's adversarial magnitudes (tests/test_delta.py)
ADVERSARIAL = np.array([1e30, -1e30, 1e-30, 1.2e-38, -2e-38, 0.0, 1.0,
                        -1.0, 3.14159, 1e6], dtype=np.float32)


def _rows(seed=0, n=4, d=32, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale).astype(np.float32)


def _roundtrip(codec, u, d):
    return codec.decode(codec.encode(None, u), u.dtype, d)


def _port(spec, base):
    return delta_lib.make_delta_codec(spec, torch.from_numpy(base))


def _ref(spec, base):
    return ref_delta.make_delta_codec(spec, jnp.asarray(base))


def _port_s(spec, base, u):
    return _roundtrip(_port(spec, base), torch.from_numpy(u),
                      u.shape[1]).numpy()


def _ref_s(spec, base, u):
    return np.asarray(_roundtrip(_ref(spec, base), jnp.asarray(u),
                                 u.shape[1]))


# ---------------------------------------------------------------------------
# Spec parsing + byte model
# ---------------------------------------------------------------------------


class TestSpec:
    @pytest.mark.parametrize("s, kind, rank", [
        ("none", "none", 0), ("full", "full", 0),
        ("topk:128", "topk", 128), ("lowrank:8", "lowrank", 8)])
    def test_parse(self, s, kind, rank):
        spec = delta_lib.parse_delta(s)
        ref = ref_delta.parse_delta(s)
        assert (spec.kind, spec.rank) == (ref.kind, ref.rank) == (kind, rank)
        assert spec.spec_str == ref.spec_str == s

    @pytest.mark.parametrize("bad", ["banana", "topk", "topk:", "topk:0",
                                     "topk:-3", "topk:x", "lowrank:0",
                                     "full:2", ""])
    def test_parse_rejects(self, bad):
        with pytest.raises(ValueError) as ref_err:
            ref_delta.parse_delta(bad)
        with pytest.raises(ValueError) as err:
            delta_lib.parse_delta(bad)
        assert str(err.value) == str(ref_err.value)

    def test_lossless_flags(self):
        for s in ("none", "full", "topk:4", "lowrank:2"):
            assert delta_lib.parse_delta(s).is_lossless \
                == ref_delta.parse_delta(s).is_lossless
        assert delta_lib.parse_delta("full").is_lossless
        assert not delta_lib.parse_delta("topk:4").is_lossless

    @pytest.mark.parametrize("d, want", [(2048, (32, 64)), (25, (5, 5)),
                                         (13, (1, 13)), (12, (3, 4)),
                                         (1, (1, 1)),
                                         (156_519_168, (12_336, 12_688)),
                                         (18_744_576, (768, 24_407))])
    def test_factor_dims(self, d, want):
        d1, d2 = delta_lib.factor_dims(d)
        assert (d1, d2) == want == ref_delta.factor_dims(d)
        assert d1 * d2 == d and d1 <= d2

    @pytest.mark.parametrize("s", ["none", "full", "topk:7", "topk:4096",
                                   "lowrank:3", "lowrank:999"])
    @pytest.mark.parametrize("d", [25, 64, 2048])
    def test_analysis_mirror_agrees(self, s, d):
        """The port's byte model and the reference's jax-free mirror
        (repro.launch.analysis) never drift apart."""
        spec = delta_lib.parse_delta(s)
        assert (delta_lib.delta_store_bytes_per_row(spec, d)
                == analysis.delta_row_bytes(s, d)
                == ref_delta.delta_store_bytes_per_row(
                    ref_delta.parse_delta(s), d))

    def test_codec_wire_bytes_match_model(self):
        d = 64
        for s in ("full", "topk:7", "lowrank:3"):
            codec = delta_lib.make_delta_codec(s, torch.zeros(d))
            assert (codec.wire_bytes_per_row(d)
                    == delta_lib.delta_store_bytes_per_row(
                        delta_lib.parse_delta(s), d)
                    == _ref(s, np.zeros(d, np.float32)).wire_bytes_per_row(d))

    def test_store_ratio_acceptance_shape(self):
        """topk:128 at D=2048: the port's store (base + rows + counters)
        is the reference cost model's, ≤ 0.25× the dense store."""
        n_total, d = 10**6, 2048
        row = delta_lib.delta_store_bytes_per_row(
            delta_lib.parse_delta("topk:128"), d)
        ratio = (d * 4 + n_total * (row + 8)) / (n_total * (d * 4 + 8))
        m = analysis.delta_cost_model(n_total=n_total, d=d,
                                      delta="topk:128")
        assert ratio == m["store_ratio"] and ratio <= 0.25


# ---------------------------------------------------------------------------
# Codec round-trips
# ---------------------------------------------------------------------------


class TestCodecs:
    def test_full_codec_bitwise_roundtrip_adversarial(self):
        n, d = 4, ADVERSARIAL.size * 2
        rng = np.random.default_rng(1)
        u = np.concatenate(
            [np.tile(ADVERSARIAL, (n, 1)),
             rng.standard_normal((n, ADVERSARIAL.size)).astype(np.float32)],
            axis=1)
        base = rng.standard_normal(d).astype(np.float32)
        base[:3] = [1e30, -1e-35, 0.0]
        s = _port_s("full", base, u)
        np.testing.assert_array_equal(s, u)
        np.testing.assert_array_equal(s, _ref_s("full", base, u))

    @pytest.mark.parametrize("scale", [1e-30, 1e-6, 1.0, 1e6, 1e30])
    @pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
    def test_full_codec_lossless_property(self, seed, scale):
        """decode(encode(x)) == x bit for bit at rank=full, so the EF
        residual is exactly zero, over magnitudes from 1e-30 to 1e30 (the
        port keeps subnormal differences, which the reference's CPU
        arithmetic flushes)."""
        u = _rows(seed, scale=scale)
        base = _rows(seed + 1, n=1, scale=scale)[0]
        s = _port_s("full", base, u)
        np.testing.assert_array_equal(s, u)        # lossless ...
        np.testing.assert_array_equal(u - s, 0.0)  # ... with zero residual

    @pytest.mark.parametrize("seed,k", [(0, 1), (1, 3), (2, 8), (3, 17),
                                        (4, 31), (5, 32), (6, 40)])
    def test_topk_codec_error_bounded_property(self, seed, k):
        """At low rank the error never exceeds the full deviation |x − b|
        componentwise, kept entries reconstruct x, and the decoded rows
        are the reference's bit for bit (the same kept set)."""
        u = _rows(seed)
        base = _rows(seed + 1, n=1)[0]
        s = _port_s(f"topk:{k}", base, u)
        np.testing.assert_array_equal(s, _ref_s(f"topk:{k}", base, u))
        dev = np.abs(u - base[None, :])
        assert (np.abs(u - s) <= dev * (1 + 1e-5) + 1e-30).all()
        if k >= u.shape[1]:
            np.testing.assert_allclose(s, u, rtol=1e-5, atol=1e-6)

    def test_topk_ties_go_to_the_lower_index(self):
        """Rows of equal magnitudes: the kept set is lax.top_k's."""
        u = np.array([[3.0, -3.0, 1.0, 3.0, -1.0, 0.5, -3.0, 2.0],
                      [1.0, 1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0]],
                     dtype=np.float32)
        base = np.zeros(8, np.float32)
        for k in (1, 2, 3, 4, 5):
            np.testing.assert_array_equal(_port_s(f"topk:{k}", base, u),
                                          _ref_s(f"topk:{k}", base, u))

    def test_lowrank_codec_error_bounded(self):
        u = _rows(3, n=4, d=36)
        base = _rows(4, n=1, d=36)[0]
        dev = np.linalg.norm(u - base[None, :], axis=1)
        prev = None
        for r in (1, 3, 6):
            s = _port_s(f"lowrank:{r}", base, u)
            want = _ref_s(f"lowrank:{r}", base, u)
            assert np.abs(s - want).max() <= LOWRANK_TOL * np.abs(u).max()
            err = np.linalg.norm(u - s, axis=1)
            assert (err <= dev * (1 + 1e-4)).all()
            if prev is not None:       # higher rank never increases error
                assert (err <= prev * (1 + 1e-4)).all()
            prev = err
        # rank == d1 is exact up to fp noise (full SVD reconstruction)
        np.testing.assert_allclose(s, u, rtol=1e-4, atol=1e-5)

    def test_np_topk_matches_jax_tie_order(self):
        """The DeltaStore's numpy encoder picks lax.top_k's entries, ties
        included, in its order; the torch codec keeps the same set."""
        base = np.zeros(8, np.float32)
        u = np.array([[3.0, -3.0, 1.0, 3.0, -1.0, 0.5, -3.0, 2.0]],
                     dtype=np.float32)
        pj = _ref("topk:4", base).encode(None, jnp.asarray(u))
        vn, idxn = delta_lib._np_topk_encode(u, base, 4)
        np.testing.assert_array_equal(np.asarray(pj["i"]), idxn)
        np.testing.assert_array_equal(np.asarray(pj["v"]), vn)
        pt = _port("topk:4", base).encode(None, torch.from_numpy(u))
        np.testing.assert_array_equal(pt["i"].numpy()[0], np.sort(idxn[0]))


# ---------------------------------------------------------------------------
# The flat engine under --delta, against the reference's
# ---------------------------------------------------------------------------


def _quadratic(rounds):
    """tests/test_torch_engine.py's quadratic (D = 2196), its start row
    from a seed: a random start and random targets, so every agent's
    delta has a flat spectrum (σ 10.9, 9.7, 9.2, 9.0, ... after a round:
    no rank stands out)."""
    rng = np.random.default_rng(42)
    d = 211 + 5 * 397
    return (SHAPES, _ref_grad_fn, _torch_grad_fn,
            rng.standard_normal(d).astype(np.float32), _batches(rounds))


def _low_rank_targets(rounds):
    """0.5·|x − t|² on one (2196,) leaf whose targets lie in base +
    span{M1, M2} (two rank-1 matrices in the (36, 61) view of
    factor_dims): every iterate, mix and server average stays there, so
    each agent's delta has rank 2 up to rounding, as low-rank deltas are
    meant to."""
    rng = np.random.default_rng(5)
    d1, d2 = delta_lib.factor_dims(2196)
    base = rng.standard_normal(d1 * d2).astype(np.float32)
    mats = np.stack([np.outer(rng.standard_normal(d1),
                              rng.standard_normal(d2)).reshape(-1)
                     for _ in range(2)])
    batches = [{"t": (base + rng.standard_normal((H, N, 2)) @ mats).astype(
        np.float32)} for _ in range(rounds)]

    def ref_grad_fn(params, batch, key):
        del key
        return jax.value_and_grad(lambda p, b: 0.5 * jnp.sum(
            jnp.square(p["x"] - b["t"])))(params, batch)

    torch_grad_fn = engine.value_and_grad(lambda p, b: 0.5 * torch.sum(
        torch.square(p["x"] - b["t"])))
    return {"x": (d1 * d2,)}, ref_grad_fn, torch_grad_fn, base, batches


def _run_both(delta, impl="dense", fused=False, opt="sgd", rounds=2,
              problem=_quadratic):
    """``problem`` through both flat engines with ``delta`` and the base
    row = the start row, from the same numpy start (every agent on the
    base, then apart), under the reference's replayed draws."""
    shapes, ref_grad_fn, torch_grad_fn, row0, all_batches = problem(rounds)
    g = ref_topo.ring_graph(N, k=2)
    rcfg = RefFedDecConfig(mixing=RefMixing(g, scheme="metropolis"), h=H,
                           k=K, gossip_impl=impl, delta=delta)
    cfg = feddec.FedDecConfig(
        mixing=MixingDistribution(topo.Graph(g.adjacency),
                                  scheme="metropolis"),
        h=H, k=K, gossip_impl=impl, delta=delta)
    ref_opt = {"sgd": None, "momentum": ref_optim.momentum_sgd()}[opt]
    port_opt = {"sgd": None, "momentum": optim.momentum_sgd()}[opt]
    shapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    ref_spec = ref_flat.make_flat_spec(shapes)
    flat0 = np.tile(row0, (N, 1))
    base = row0 if delta != "none" else None
    has_res = delta != "none" and impl != "none"
    rstate = ref_flat.FlatFedState(
        flat=jnp.asarray(flat0), step=jnp.asarray(1, jnp.int32),
        opt_state=() if ref_opt is None else jnp.zeros_like(flat0),
        residual=jnp.zeros_like(flat0) if has_res else ())
    round_ref = ref_flat.make_flat_feddec_round(
        rcfg, ref_spec, ref_grad_fn,
        lambda t: jnp.asarray(ETA, jnp.float32), optimizer=ref_opt,
        donate=False, fuse_update_mix=fused,
        delta_base=None if base is None else jnp.asarray(base))

    params1 = flat_lib.params_from_numpy(
        jax.tree.map(np.asarray, ref_spec.unravel(jnp.asarray(row0))))
    spec = flat_lib.make_flat_spec(params1)
    state = flat_lib.init_flat_state(spec, params1, N, optimizer=port_opt,
                                     delta=delta if impl != "none"
                                     else "none")
    eta = torch.tensor([ETA])
    round_fn = flat_lib.make_flat_feddec_round(
        cfg, spec, torch_grad_fn, lambda t: eta, device="cpu",
        optimizer=port_opt, fuse_update_mix=fused,
        delta_base=None if base is None else torch.from_numpy(base))
    key = jax.random.key(7)
    draws = ReplayDraws(key)
    ref_losses, losses = [], []
    for batches in all_batches:
        rstate, rmet = round_ref(rstate, jax.tree.map(jnp.asarray, batches),
                                 key)
        ref_losses.extend(np.asarray(rmet["loss"]).tolist())
        state, met = round_fn(state, {k: torch.from_numpy(v)
                                      for k, v in batches.items()}, draws)
        losses.extend(met["loss"].tolist())
    return rstate, state, ref_losses, losses


def _assert_engines_agree(delta, rstate, state, ref_losses, losses,
                          tol=TOL):
    assert state.step == int(rstate.step) == 1 + 2 * H
    want = np.asarray(rstate.flat)
    scale = np.abs(want).max()
    assert np.abs(state.flat.numpy() - want).max() <= tol * scale
    assert np.abs(state.residual.numpy()
                  - np.asarray(rstate.residual)).max() <= tol * scale
    if delta == "full":
        assert not state.residual.any()
    else:
        assert state.residual.abs().max() > 0
    np.testing.assert_allclose(losses, ref_losses, rtol=tol)


ENGINE_CELLS = (("dense", False, "sgd"), ("pallas", False, "sgd"),
                ("sparse", False, "momentum"), ("dense", True, "momentum"),
                ("pallas", True, "sgd"), ("sparse", True, "sgd"))
DELTA_CELLS = [(d, impl, fused, opt) for d in ("full", "topk:500",
                                               "lowrank:2", "lowrank:3")
               for impl, fused, opt in ENGINE_CELLS]


def _cell_id(cell):
    d, i, f, o = cell
    return f"{d}-{i}-{'fused' if f else 'unfused'}-{o}"


@pytest.mark.parametrize("delta,impl,fused,opt", DELTA_CELLS,
                         ids=[_cell_id(c) for c in DELTA_CELLS])
def test_delta_engine_matches_reference(delta, impl, fused, opt):
    """flat, residual and losses of the port's delta engine against the
    reference's ``make_flat_feddec_round(..., delta_base=...)``: the
    unfused EF exchange mixes the decoded s with #1 (pallas) or #2
    (sparse), the fused one runs #9 (dense/pallas) or #11 (sparse),
    their plain versions here.  The low-rank codecs run on deltas of rank
    2 (:func:`_low_rank_targets`), where the truncation is well posed."""
    problem = _low_rank_targets if delta.startswith("lowrank") \
        else _quadratic
    _assert_engines_agree(delta, *_run_both(delta, impl, fused, opt,
                                            problem=problem))


@pytest.mark.parametrize("impl,fused,opt", ENGINE_CELLS,
                         ids=[_cell_id(("lowrank:3",) + c)
                              for c in ENGINE_CELLS])
def test_lowrank_engine_on_flat_spectra(impl, fused, opt):
    """lowrank:3 on the quadratic's random deltas, whose singular values
    lie within 20% of each other (σ_3 − σ_4 ≈ 0.2 at σ_1 ≈ 11): the
    rank-3 subspace is ill-conditioned, and the two LAPACKs' f32 SVDs
    differ by about eps·σ_1/(σ_3 − σ_4) ≈ 50 eps a step.  Held to
    LOWRANK_FLAT_TOL, stated from that conditioning: 20× the engine
    tolerance (the port measured 2.1e-5 on the buffer, 8.3e-5 on the
    residual, × max|x|)."""
    _assert_engines_agree("lowrank:3", *_run_both("lowrank:3", impl, fused,
                                                  opt), tol=LOWRANK_FLAT_TOL)


class TestEngine:
    @pytest.mark.parametrize("gossip_impl", ["dense", "sparse", "pallas"])
    @pytest.mark.parametrize("fused", [False, True])
    def test_rank_full_bit_identical(self, gossip_impl, fused):
        """delta='full' equals the port's own delta='none' run bit for
        bit, with an all-zero residual, and the reference's full run
        within the engines' tolerance."""
        ref, none, ref_l, l_none = _run_both("none", gossip_impl, fused)
        _, full, _, l_full = _run_both("full", gossip_impl, fused)
        assert torch.equal(full.flat, none.flat)
        assert not full.residual.any()
        assert l_full == l_none
        assert np.abs(full.flat.numpy() - np.asarray(ref.flat)).max() \
            <= TOL * np.abs(np.asarray(ref.flat)).max()
        np.testing.assert_allclose(l_full, ref_l, rtol=1e-5)

    def test_topk_delta_runs_and_converges_nearby(self):
        _, none, _, _ = _run_both("none")
        ref, got, _, _ = _run_both("topk:1500")   # k ≥ 2/3 of the row
        assert torch.isfinite(got.flat).all()
        assert got.residual.abs().max() > 0
        assert (got.flat - none.flat).abs().max() < 1.0
        assert np.abs(got.flat.numpy() - np.asarray(ref.flat)).max() \
            <= TOL * np.abs(np.asarray(ref.flat)).max()

    def test_delta_and_compress_mutually_exclusive(self):
        g = ref_topo.ring_graph(6, 1)
        with pytest.raises(ValueError, match="mutually exclusive") as ref_e:
            RefFedDecConfig(mixing=RefMixing(g), delta="full",
                            gossip_compress="int8")
        with pytest.raises(ValueError, match="mutually exclusive") as e:
            feddec.FedDecConfig(
                mixing=MixingDistribution(topo.Graph(g.adjacency)),
                delta="full", gossip_compress="int8")
        assert str(e.value) == str(ref_e.value)

    def test_bad_delta_spec_rejected_at_config(self):
        g = topo.ring_graph(6, 1)
        with pytest.raises(ValueError, match="unknown delta spec"):
            feddec.FedDecConfig(mixing=MixingDistribution(g), delta="banana")

    def test_init_flat_state_carries_residual(self):
        spec = flat_lib.make_flat_spec({"x": torch.zeros(10)})
        st = flat_lib.init_flat_state(spec, {"x": torch.zeros(10)}, 4,
                                      delta="full")
        assert isinstance(st.residual, torch.Tensor)
        assert st.residual.shape == (4, 10) and not st.residual.any()
        st0 = flat_lib.init_flat_state(spec, {"x": torch.zeros(10)}, 4)
        assert isinstance(st0.residual, tuple)

    def _cfgs(self, delta="full", n=8):
        g = ref_topo.ring_graph(n, 1)
        return (RefFedDecConfig(mixing=RefMixing(g), h=2, k=2, delta=delta),
                feddec.FedDecConfig(
                    mixing=MixingDistribution(topo.Graph(g.adjacency)),
                    h=2, k=2, delta=delta))

    def _same_error(self, ref_call, port_call, match):
        with pytest.raises(ValueError, match=match) as ref_err:
            ref_call()
        with pytest.raises(ValueError, match=match) as err:
            port_call()
        assert str(err.value) == str(ref_err.value)

    def test_lattice_rejects_tree_layout(self):
        rc, c = self._cfgs()
        self._same_error(
            lambda: ref_engine.parse_engine_spec(rc, layout="tree"),
            lambda: engine.parse_engine_spec(c, layout="tree"), "flat")

    def test_lattice_rejects_sweeps(self):
        rc, c = self._cfgs()
        self._same_error(
            lambda: ref_engine.parse_engine_spec([rc, rc], layout="flat"),
            lambda: engine.parse_engine_spec([c, c], layout="flat"),
            "single-run")
        self._same_error(
            lambda: ref_engine.parse_engine_spec(rc, layout="flat",
                                                 force_run_axis=True),
            lambda: engine.parse_engine_spec(c, layout="flat",
                                             force_run_axis=True),
            "single-run")

    def test_lattice_rejects_sharding(self):
        rc, c = self._cfgs()
        self._same_error(
            lambda: ref_engine.parse_engine_spec(rc, layout="flat",
                                                 n_shards=2),
            lambda: engine.parse_engine_spec(c, layout="flat", n_shards=2),
            "single-device")

    def test_lattice_rejects_mixed_delta(self):
        (rn, n), (rf, f) = self._cfgs("none"), self._cfgs("full")
        self._same_error(
            lambda: ref_engine.parse_engine_spec(
                [rn, rf], layout="flat", force_run_axis=True),
            lambda: engine.parse_engine_spec(
                [n, f], layout="flat", force_run_axis=True),
            "share one delta")

    def test_delta_base_shape_checked(self):
        rc, c = self._cfgs()
        self._same_error(
            lambda: ref_flat.make_flat_feddec_round(
                rc, ref_flat.make_flat_spec(jnp.zeros(10)),
                lambda p, b, k: (p, 0.0), lambda t: 1e-3,
                delta_base=jnp.zeros(7)),
            lambda: flat_lib.make_flat_feddec_round(
                c, flat_lib.make_flat_spec({"x": torch.zeros(10)}),
                _torch_grad_fn, lambda t: torch.tensor([1e-3]),
                device="cpu", delta_base=torch.zeros(7)),
            "delta_base")

    def test_delta_base_without_delta_rejected(self):
        rc, c = self._cfgs("none")
        self._same_error(
            lambda: ref_flat.make_flat_feddec_round(
                rc, ref_flat.make_flat_spec(jnp.zeros(10)),
                lambda p, b, k: (p, 0.0), lambda t: 1e-3,
                delta_base=jnp.zeros(10)),
            lambda: flat_lib.make_flat_feddec_round(
                c, flat_lib.make_flat_spec({"x": torch.zeros(10)}),
                _torch_grad_fn, lambda t: torch.tensor([1e-3]),
                device="cpu", delta_base=torch.zeros(10)),
            "delta='none'")


# ---------------------------------------------------------------------------
# DeltaStore
# ---------------------------------------------------------------------------


class TestDeltaStore:
    def test_create_rejects_none(self):
        with pytest.raises(ValueError, match="non-'none'"):
            delta_lib.DeltaStore.create(8, np.zeros(4, np.float32), "none")

    def test_payload_leading_dim_checked(self):
        spec = delta_lib.parse_delta("full")
        with pytest.raises(ValueError, match="leading dim"):
            delta_lib.DeltaStore(spec, np.zeros(4, np.float32),
                                 {"p": np.zeros((3, 4), np.float32),
                                  "c": np.zeros((5, 4), np.float32)},
                                 np.full(3, -1))

    @pytest.mark.parametrize("s", ["full", "topk:6", "lowrank:2"])
    def test_fresh_store_serves_the_base(self, s):
        base = _rows(7, n=1, d=16)[0]
        store = delta_lib.DeltaStore.create(10, base, s)
        got = store.gather(np.array([0, 3, 9]))
        np.testing.assert_allclose(got, np.tile(base, (3, 1)),
                                   rtol=1e-6, atol=1e-7)
        assert store.n_total == 10 and store.d == 16

    def test_full_store_roundtrip_bitwise(self):
        base = np.concatenate([ADVERSARIAL[:4],
                               _rows(8, n=1, d=12)[0]]).astype(np.float32)
        rows = _rows(9, n=5, d=16, scale=1e3)
        rows[0, :ADVERSARIAL.size] = ADVERSARIAL[:16]
        store = delta_lib.DeltaStore.create(8, base, "full")
        ids = np.array([0, 2, 4, 5, 7])
        store.scatter(ids, rows)
        np.testing.assert_array_equal(store.gather(ids), rows)

    def test_full_store_matches_the_codecs_bitwise(self):
        """Host gather, the port's torch decode and the reference's jax
        decode agree bit for bit: one op order."""
        base = _rows(10, n=1, d=24)[0]
        rows = _rows(11, n=4, d=24, scale=50.0)
        store = delta_lib.DeltaStore.create(4, base, "full")
        store.scatter(np.arange(4), rows)
        got = store.gather(np.arange(4))
        np.testing.assert_array_equal(got, _port_s("full", base, rows))
        np.testing.assert_array_equal(got, _ref_s("full", base, rows))

    def test_topk_store_error_bounded_and_small(self):
        d, k, n = 64, 8, 32
        base = _rows(12, n=1, d=d)[0]
        rows = base[None, :] + _rows(13, n=n, d=d, scale=0.01)
        store = delta_lib.DeltaStore.create(n, base, f"topk:{k}")
        store.scatter(np.arange(n), rows)
        got = store.gather(np.arange(n))
        dev = np.abs(rows - base[None, :])
        assert (np.abs(got - rows) <= dev * (1 + 1e-5) + 1e-30).all()
        dense_bytes = n * d * 4
        assert sum(a.nbytes for a in store.payload.values()) < dense_bytes

    def test_lowrank_store_roundtrip(self):
        d, n = 36, 6
        base = _rows(14, n=1, d=d)[0]
        rows = base[None, :] + _rows(15, n=n, d=d, scale=0.1)
        store = delta_lib.DeltaStore.create(n, base, "lowrank:6")
        store.scatter(np.arange(n), rows)
        # rank 6 == d1: exact SVD reconstruction up to fp noise
        np.testing.assert_allclose(store.gather(np.arange(n)), rows,
                                   rtol=1e-4, atol=1e-5)

    def test_nbytes_matches_cost_model(self):
        for s in ("full", "topk:16", "lowrank:2"):
            store = delta_lib.DeltaStore.create(
                100, np.zeros(64, np.float32), s)
            model = analysis.delta_cost_model(n_total=100, d=64, delta=s)
            assert store.nbytes == model["delta_store_bytes"]

    def test_ages(self):
        store = delta_lib.DeltaStore.create(8, np.zeros(4, np.float32),
                                            "topk:2")
        store.last_round[2] = 5
        ages = store.ages(np.array([0, 2]), 7)
        np.testing.assert_array_equal(ages, [8, 2])

    def test_save_restore_roundtrip(self, tmp_path):
        base = _rows(16, n=1, d=16)[0]
        rows = base[None, :] + _rows(17, n=6, d=16, scale=0.05)
        store = delta_lib.DeltaStore.create(6, base, "topk:4")
        store.scatter(np.arange(6), rows)
        store.last_round[:] = 3
        store.save(str(tmp_path), step=12)
        back = delta_lib.DeltaStore.restore(str(tmp_path), step=12)
        assert back.spec == store.spec
        np.testing.assert_array_equal(back.base, store.base)
        np.testing.assert_array_equal(back.last_round, store.last_round)
        np.testing.assert_array_equal(back.gather(np.arange(6)),
                                      store.gather(np.arange(6)))

    def test_restore_latest(self, tmp_path):
        store = delta_lib.DeltaStore.create(4, np.zeros(8, np.float32),
                                            "full")
        store.save(str(tmp_path), step=1)
        store.scatter(np.arange(4), np.ones((4, 8), np.float32))
        store.save(str(tmp_path), step=2)
        back = delta_lib.DeltaStore.restore(str(tmp_path))
        np.testing.assert_array_equal(back.gather(np.arange(4)),
                                      np.ones((4, 8), np.float32))

    def test_restore_empty_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            delta_lib.DeltaStore.restore(str(tmp_path))

    @pytest.mark.parametrize("s", ["full", "topk:5", "lowrank:2"])
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_checkpoints_cross_between_the_packages(self, s, writer,
                                                    tmp_path):
        """A store saved by one package restores in the other bit for
        bit: payload, base, counters and the decoded rows."""
        base = _rows(18, n=1, d=36)[0]
        rows = base[None, :] + _rows(19, n=5, d=36, scale=0.1)
        classes = {"reference": ref_delta.DeltaStore,
                   "port": delta_lib.DeltaStore}
        src = classes[writer].create(5, base, s)
        src.scatter(np.arange(5), rows)
        src.last_round[:] = [0, 3, 1, 4, 2]
        src.save(str(tmp_path), step=7)
        other = "port" if writer == "reference" else "reference"
        back = classes[other].restore(str(tmp_path), step=7)
        assert (back.spec.kind, back.spec.rank) == (src.spec.kind,
                                                    src.spec.rank)
        np.testing.assert_array_equal(back.base, src.base)
        np.testing.assert_array_equal(back.last_round, src.last_round)
        for name, arr in src.payload.items():
            np.testing.assert_array_equal(np.asarray(back.payload[name]),
                                          np.asarray(arr))
        np.testing.assert_array_equal(back.gather(np.arange(5)),
                                      src.gather(np.arange(5)))


def test_delta_spec_replace_revalidates():
    g = topo.ring_graph(6, 1)
    cfg = feddec.FedDecConfig(mixing=MixingDistribution(g), delta="full")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, delta="nope")
