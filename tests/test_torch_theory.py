"""Theorem 1's constants in the port against the JAX package's: theory,
the spectral helpers of topology, the mixing distribution's E[WWᵀ] / |λ̂₂|
/ α, and Table 1.

``core/theory.py`` and the spectral helpers are numpy in both packages
(tolerance 1e-12 relative; they agree exactly).  With link failures,
E[WWᵀ] is a Monte-Carlo mean: the port's is fed the reference's own 4,096
uniforms (``split(key, 4096)``, one (n, n) block each) and held to it
within 1e-12·max|E[WWᵀ]| in float64 (other summation order), under
``with jax.enable_x64(True):``.  Table 1 is host numpy: its cells equal the
reference's exactly for the same graph seeds.  The spectral tests mirror
tests/test_topology.py::TestSpectral and tests/test_feddec.py::TestTheory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig2_alpha as ref_fig2
from benchmarks import table1_lambda2 as ref_table1
from repro.core import theory as ref_theory
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro_torch.core import theory, topology as topo
from repro_torch.core.mixing import MixingDistribution
from repro_torch.experiments import fig2_alpha, table1_lambda2

RTOL = 1e-12

GRAPHS = {
    "chain": lambda m: m.chain_graph(12),
    "ring2": lambda m: m.ring_graph(20, k=2),
    "geo": lambda m: m.geographic_graph(20, 0.5, seed=1),
    "geo35": lambda m: m.geographic_graph(20, 0.35, seed=1),
    "er": lambda m: m.erdos_renyi_graph(15, 0.4, seed=2),
    "full": lambda m: m.fully_connected_graph(9),
}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (got, want)


# ---------------------------------------------------------------------------
# core/theory.py
# ---------------------------------------------------------------------------

INPUTS = [dict(l_smooth=1.0, mu=0.1, g2=1.0, sigma_bar2=0.5,
               gamma_heterogeneity=1.0, n=20, k=2, h=10, lambda2_hat=0.5,
               dist0_sq=4.0),
          dict(l_smooth=173.2, mu=0.0137, g2=3.1e9, sigma_bar2=2.2e8,
               gamma_heterogeneity=5.5e9, n=20, k=2, h=100,
               lambda2_hat=0.6413, dist0_sq=9.7e7),
          dict(l_smooth=4.0, mu=0.5, g2=2.0, sigma_bar2=0.0,
               gamma_heterogeneity=0.3, n=7, k=3, h=64, lambda2_hat=0.0,
               dist0_sq=1.0)]


@pytest.mark.parametrize("kw", INPUTS, ids=["unit", "paper-like", "edge"])
def test_theory_matches_the_reference(kw):
    _close(theory.alpha(kw["lambda2_hat"]),
           ref_theory.alpha(kw["lambda2_hat"]))
    _close(theory.gamma(kw["l_smooth"], kw["mu"], kw["h"]),
           ref_theory.gamma(kw["l_smooth"], kw["mu"], kw["h"]))
    common = {k: kw[k] for k in ("k", "h", "g2", "l_smooth",
                                 "gamma_heterogeneity", "sigma_bar2", "n")}
    a = ref_theory.alpha(kw["lambda2_hat"])
    _close(theory.bound_constant_B(alpha_val=a, **common),
           ref_theory.bound_constant_B(alpha_val=a, **common))
    _close(theory.fedavg_bound_constant(**common),
           ref_theory.fedavg_bound_constant(**common))
    g = ref_theory.gamma(kw["l_smooth"], kw["mu"], kw["h"])
    t = np.arange(1, 40)
    _close(theory.paper_stepsize(kw["mu"], g)(t),
           ref_theory.paper_stepsize(kw["mu"], g)(t))
    bkw = dict(l_smooth=kw["l_smooth"], mu=kw["mu"], b_const=3.3,
               gamma_val=g, dist0_sq=kw["dist0_sq"])
    _close(theory.convergence_bound(t, **bkw),
           ref_theory.convergence_bound(t, **bkw))
    _close(theory.theorem1_curve(theory.TheoremInputs(**kw), 300),
           ref_theory.theorem1_curve(ref_theory.TheoremInputs(**kw), 300))


class TestTheory:
    def test_bound_constants(self):
        assert theory.alpha(0.64) == pytest.approx(0.64 / 0.36)
        assert theory.gamma(l_smooth=4.0, mu=0.5, h=100) == 100
        assert theory.gamma(l_smooth=100.0, mu=0.5, h=10) == \
            pytest.approx(8 * 200 - 1)
        with pytest.raises(ValueError):
            theory.alpha(1.0)

    def test_feddec_B_below_fedavg_C(self):
        """O(αH) < O(H²) whenever α < H: the paper's Thm-1-vs-[16] gap."""
        kw = dict(k=2, g2=1.0, l_smooth=1.0, gamma_heterogeneity=1.0,
                  sigma_bar2=1.0, n=20)
        assert theory.bound_constant_B(alpha_val=1.8, h=100, **kw) < \
            theory.fedavg_bound_constant(h=100, **kw)

    def test_bound_decreases_in_t(self):
        curve = theory.theorem1_curve(theory.TheoremInputs(**INPUTS[0]), 100)
        assert (np.diff(curve) < 0).all()

    def test_bound_improves_with_connectivity(self):
        base = {k: v for k, v in INPUTS[0].items() if k != "lambda2_hat"}
        dense = theory.theorem1_curve(
            theory.TheoremInputs(lambda2_hat=0.1, **base), 50)
        sparse = theory.theorem1_curve(
            theory.TheoremInputs(lambda2_hat=0.9, **base), 50)
        assert (dense <= sparse).all()


# ---------------------------------------------------------------------------
# core/topology.py: graphs and the spectral helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_spectral_helpers_match_the_reference(name):
    ref_g, g = GRAPHS[name](ref_topo), GRAPHS[name](topo)
    assert np.array_equal(g.adjacency, ref_g.adjacency)
    assert topo.is_connected(g) == ref_topo.is_connected(ref_g)
    ws = np.stack([ref_topo.build_weights(ref_g, s)
                   for s in ("laplacian", "metropolis", "max_degree")])
    for w in ws:
        _close(topo.lambda2(w), ref_topo.lambda2(w))
        _close(topo.lambda2_hat_fixed(w), ref_topo.lambda2_hat_fixed(w))
        lam = ref_topo.lambda2_hat_fixed(w)
        _close(topo.alpha_from_lambda2_hat(lam),
               ref_topo.alpha_from_lambda2_hat(lam))
    _close(topo.lambda2_batched(ws), ref_topo.lambda2_batched(ws))
    _close(topo.lambda2_hat_fixed_batched(ws),
           ref_topo.lambda2_hat_fixed_batched(ws))


def test_chain_and_connectivity():
    g = topo.chain_graph(6)
    assert g.degrees.tolist() == [1, 2, 2, 2, 2, 1]
    assert topo.is_connected(g)
    cut = topo.Graph(np.kron(np.eye(2, dtype=bool), ~np.eye(3, dtype=bool)))
    assert not topo.is_connected(cut)
    assert not ref_topo.is_connected(ref_topo.Graph(cut.adjacency))


def test_dense_size_guard():
    assert topo.check_dense_size(4096, "x") == 4096
    with pytest.raises(ValueError, match="n_dense_max=8"):
        topo.lambda2(np.eye(9), n_dense_max=8)
    with pytest.raises(ValueError):
        ref_topo.lambda2(np.eye(9), n_dense_max=8)


class TestSpectral:
    def test_lambda2_fully_connected(self):
        n = 6
        assert topo.lambda2(np.full((n, n), 1.0 / n)) < 1e-12

    def test_lambda2_hat_is_lambda2_squared(self):
        w = topo.laplacian_weights(topo.geographic_graph(12, 0.5, seed=3))
        assert topo.lambda2_hat_fixed(w) == pytest.approx(
            topo.lambda2(w) ** 2)

    def test_alpha_monotone(self):
        vals = [topo.alpha_from_lambda2_hat(x) for x in (0.0, 0.3, 0.6, 0.9)]
        assert vals[0] == 0.0
        assert vals == sorted(vals)

    def test_alpha_invalid(self):
        with pytest.raises(ValueError):
            topo.alpha_from_lambda2_hat(1.0)

    def test_paper_table1_ballpark(self):
        # Table 1: geographic n=20, r=0.5 → |λ₂|² ≈ 0.64 (avg of 10)
        vals = [topo.lambda2_hat_fixed(topo.laplacian_weights(
            topo.geographic_graph(20, 0.5, seed=s))) for s in range(10)]
        assert 0.4 < float(np.mean(vals)) < 0.85


# ---------------------------------------------------------------------------
# core/mixing.py: E[WWᵀ], |λ̂₂| and α
# ---------------------------------------------------------------------------


class _Uniforms:
    """The reference's sample_batch uniforms: draw i is uniform(split(key,
    num)[i], (n, n)), all made in one vmapped call."""

    def __init__(self, key, num, n):
        self.u = np.array(jax.vmap(lambda k: jax.random.uniform(
            k, (n, n)))(jax.random.split(key, num)))

    def link_uniforms(self, t, n):
        return torch.from_numpy(self.u[t])


@pytest.mark.parametrize("graph", ["geo", "ring2", "er"])
def test_expected_wwt_under_replayed_uniforms(graph):
    num = 4096
    ref_g, g = GRAPHS[graph](ref_topo), GRAPHS[graph](topo)
    with jax.enable_x64(True):
        ref_md = RefMixing(ref_g, p_fail=0.5, scheme="metropolis",
                           dtype=jnp.float64)
        key = jax.random.key(1)
        want = ref_md.expected_wwt(key, num)
        want_lam = ref_md.lambda2_hat(key, num)
        want_alpha = ref_md.alpha(key, num)
        draws = _Uniforms(key, num, g.n)
    md = MixingDistribution(g, p_fail=0.5, scheme="metropolis",
                            dtype=torch.float64)
    got = md.expected_wwt(draws, num)
    assert got.dtype == np.float64 and got.shape == (g.n, g.n)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    _close(md.lambda2_hat(draws, num), want_lam)
    _close(md.alpha(draws, num), want_alpha)
    ws = md.sample_batch(draws, 3)
    torch.testing.assert_close(ws.sum(dim=-1), torch.ones(3, g.n,
                                                          dtype=ws.dtype))


@pytest.mark.parametrize("graph", ["geo", "chain"])
def test_fixed_w_spectral_constants_are_exact(graph):
    ref_md = RefMixing(GRAPHS[graph](ref_topo), scheme="laplacian")
    md = MixingDistribution(GRAPHS[graph](topo), scheme="laplacian")
    assert np.array_equal(md.expected_wwt(), ref_md.expected_wwt())
    assert md.lambda2_hat() == ref_md.lambda2_hat()
    assert md.alpha() == ref_md.alpha()
    assert md.lambda2_hat() == pytest.approx(
        topo.lambda2_hat_fixed(md.fixed_w), rel=1e-12)
    assert md.sample_batch(None, 4).shape == (4, md.n, md.n)


# ---------------------------------------------------------------------------
# Table 1 and Fig. 2's curve
# ---------------------------------------------------------------------------


def test_table1_equals_the_reference():
    rows, table = table1_lambda2.run_experiment()
    ref_rows, ref_table = ref_table1.run_experiment()
    assert table == ref_table
    assert rows == ref_rows
    assert table1_lambda2.validate(table) == ref_table1.validate(ref_table)
    assert all("PASS" in c for c in table1_lambda2.validate(table))


def test_fig2_alpha_curve_equals_the_reference():
    assert fig2_alpha.run_curve() == ref_fig2.run_curve()
