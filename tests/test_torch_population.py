"""The port's population engine (repro_torch.core.population) against the
JAX package's (repro.core.population), mirroring tests/test_population.py
and the two ``TestPopulationIntegration`` tests of tests/test_delta.py.

The store, the samplers, the sparse topology (CSR graphs, induced
subgraphs, CSR Metropolis weights, λ₂), the staleness tilt, the cohort
ELL tables and the cost model are numpy on both sides: the port's must
equal the reference's exactly, cohort ids included (the same
``np.random.Generator`` calls).  The engine runs on both sides from the
same numpy batches, the reference's server draws replayed into the port
(``ReplayDraws``: ``split(fold_in(key, t), 3)``, t from 1 advancing by H
a round): the stores within TOL·max|x| (f32, other summation order).
Inside the port, bit for bit where the reference asserts it: the cohort
engine at n_total == cohort against the flat engine with
``gossip_impl='sparse'``, overlap against sync, singleton clusters against
the plain server, and a ``DeltaStore('full')`` against the dense store.
Three of the four ``TestCheckpoint`` tests (the snapshot format itself)
are mirrored in tests/test_torch_checkpoint.py; the store's own save and
restore is here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import flat as ref_flat
from repro.core import mixing as ref_mixing
from repro.core import population as ref_pop
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.data import linreg as ref_linreg
from repro.launch import analysis as ref_analysis
from repro_torch.core import engine
from repro_torch.core import flat as flat_lib
from repro_torch.core import mixing as mixing_lib
from repro_torch.core import population as pop
from repro_torch.core import topology as topo
from repro_torch.core.delta import DeltaStore
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.data import linreg
from repro_torch.launch import analysis
from test_torch_engine import ReplayDraws

TOL = 1e-5          # × max|x|: f32 engines, other summation order


# ---------------------------------------------------------------------------
# PopulationStore
# ---------------------------------------------------------------------------


class TestStore:
    def test_create_is_memmap_and_broadcasts_row(self):
        store = pop.PopulationStore.create(100, np.arange(5.0), chunk_rows=7)
        ref = ref_pop.PopulationStore.create(100, np.arange(5.0),
                                             chunk_rows=7)
        assert isinstance(store.rows, np.memmap)
        assert store.rows.shape == (100, 5)
        np.testing.assert_array_equal(store.rows[73], np.arange(5.0))
        assert store.last_round.tolist() == [-1] * 100
        np.testing.assert_array_equal(store.rows, ref.rows)
        assert store.nbytes == ref.nbytes

    def test_gather_scatter_roundtrip(self):
        store = pop.PopulationStore.create(20, np.zeros(3))
        ids = np.array([2, 7, 19])
        vals = np.arange(9.0, dtype=np.float32).reshape(3, 3)
        store.scatter(ids, vals)
        np.testing.assert_array_equal(store.gather(ids), vals)
        np.testing.assert_array_equal(store.rows[0], np.zeros(3))
        out = np.empty((3, 3), np.float32)     # the engine's staging form
        store.gather(ids, out=out)
        np.testing.assert_array_equal(out, vals)
        with pytest.raises(IndexError, match="out of range"):
            store.gather(np.array([20]), out=out[:1])

    def test_gather_returns_copy(self):
        store = pop.PopulationStore.create(4, np.ones(2))
        got = store.gather(np.array([0]))
        got[:] = 99.0
        np.testing.assert_array_equal(store.rows[0], np.ones(2))

    def test_ages_clip_at_zero(self):
        store = pop.PopulationStore.create(4, np.zeros(2))
        store.last_round[:] = [5, -1, 2, 9]
        np.testing.assert_array_equal(
            store.ages(np.arange(4), 5), [0, 6, 3, 0])

    def test_shape_validation(self):
        for mod in (pop, ref_pop):
            with pytest.raises(ValueError, match="rows must be"):
                mod.PopulationStore(np.zeros(3), np.zeros(3))
            with pytest.raises(ValueError, match="last_round"):
                mod.PopulationStore(np.zeros((3, 2)), np.zeros(4))


class TestCheckpoint:
    def test_store_save_restore(self, tmp_path):
        store = pop.PopulationStore.create(9, np.zeros(3), chunk_rows=4)
        store.scatter(np.array([1, 8]), np.full((2, 3), 2.5, np.float32))
        store.last_round[:] = np.arange(9)
        store.save(str(tmp_path), 42)
        back = pop.PopulationStore.restore(str(tmp_path))
        np.testing.assert_array_equal(back.rows, store.rows)
        np.testing.assert_array_equal(back.last_round, store.last_round)
        back.scatter(np.array([0]), np.ones((1, 3), np.float32))  # writable
        # the reference restores the port's snapshot, and the port the
        # reference's
        ref_back = ref_pop.PopulationStore.restore(str(tmp_path))
        np.testing.assert_array_equal(ref_back.rows, store.rows)
        np.testing.assert_array_equal(ref_back.last_round, store.last_round)
        ref_back.save(str(tmp_path / "ref"), 43)
        again = pop.PopulationStore.restore(str(tmp_path / "ref"), 43)
        np.testing.assert_array_equal(again.rows, store.rows)


# ---------------------------------------------------------------------------
# Cohort sampling: the same ids as the reference, call for call
# ---------------------------------------------------------------------------


def _both_cohorts(seed: int, rounds: int = 3, weights=None, **kw):
    """Cohort ids of ``rounds`` rounds from the port's and the
    reference's sampler, each on its own Generator of ``seed``, the
    staleness counters advanced as the engine advances them."""
    spec = pop.PopulationSpec(**kw)
    ref_spec = ref_pop.PopulationSpec(**kw)
    out = []
    for mod, sp in ((pop, spec), (ref_pop, ref_spec)):
        rng = np.random.default_rng(seed)
        last = np.full(sp.n_total, -1, np.int64)
        ids = []
        for r in range(rounds):
            ids.append(mod.sample_cohort(rng, sp, last, r, weights))
            last[ids[-1]] = r
        out.append(ids)
    return out


class TestSampling:
    def _spec(self, **kw):
        base = dict(n_total=50, cohort_size=10)
        base.update(kw)
        return pop.PopulationSpec(**base)

    def test_uniform_sorted_unique(self):
        rng = np.random.default_rng(0)
        last = np.full(50, -1, np.int64)
        ids = pop.sample_cohort(rng, self._spec(), last, 0)
        assert ids.dtype == np.int64
        assert len(np.unique(ids)) == 10
        np.testing.assert_array_equal(ids, np.sort(ids))

    def test_full_cohort_is_identity_slice(self):
        rng = np.random.default_rng(0)
        spec = self._spec(n_total=10, cohort_size=10)
        ids = pop.sample_cohort(rng, spec, np.full(10, -1, np.int64), 0)
        np.testing.assert_array_equal(ids, np.arange(10))

    def test_stale_prioritizes_left_out_agents(self):
        rng = np.random.default_rng(0)
        spec = self._spec(sampling="stale")
        last = np.zeros(50, np.int64)
        last[:10] = -10**9         # ten agents far staler than the rest
        ids = pop.sample_cohort(rng, spec, last, round_idx=1)
        np.testing.assert_array_equal(ids, np.arange(10))

    def test_weighted_follows_weights(self):
        rng = np.random.default_rng(0)
        spec = self._spec(sampling="weighted")
        w = np.zeros(50)
        w[20:30] = 1.0             # only these are sampleable
        ids = pop.sample_cohort(rng, spec, np.full(50, -1, np.int64), 0,
                                weights=w)
        np.testing.assert_array_equal(ids, np.arange(20, 30))

    def test_weighted_validation(self):
        rng = np.random.default_rng(0)
        spec = self._spec(sampling="weighted")
        last = np.full(50, -1, np.int64)
        with pytest.raises(ValueError, match="needs a per-agent weights"):
            pop.sample_cohort(rng, spec, last, 0)
        with pytest.raises(ValueError, match="positive sum"):
            pop.sample_cohort(rng, spec, last, 0, weights=np.zeros(50))

    def test_spec_validation(self):
        for args, kw, match in (((10, 11), {}, "cohort_size"),
                                ((10, 2), {"sampling": "roulette"},
                                 "unknown sampling"),
                                ((10, 2), {"staleness": -1.0}, "staleness"),
                                ((10, 2), {"n_clusters": 3}, "n_clusters")):
            with pytest.raises(ValueError, match=match) as err:
                pop.PopulationSpec(*args, **kw)
            with pytest.raises(ValueError) as ref_err:
                ref_pop.PopulationSpec(*args, **kw)
            assert str(err.value) == str(ref_err.value)

    @pytest.mark.parametrize("sampling", ["uniform", "weighted", "stale"])
    @pytest.mark.parametrize("n_total,cohort", [(50, 10), (20_000, 64)])
    def test_cohort_ids_equal_the_reference(self, sampling, n_total,
                                            cohort):
        weights = np.random.default_rng(9).random(n_total) \
            if sampling == "weighted" else None
        got, want = _both_cohorts(3, weights=weights, n_total=n_total,
                                  cohort_size=cohort, sampling=sampling)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        spec = pop.PopulationSpec(n_total, cohort)
        ref_spec = ref_pop.PopulationSpec(n_total, cohort, n_clusters=0)
        np.testing.assert_array_equal(spec.cluster_of(got[0]),
                                      ref_spec.cluster_of(got[0]))


# ---------------------------------------------------------------------------
# Sparse topology (SparseGraph, induced subgraph, CSR weights, λ₂): exact
# ---------------------------------------------------------------------------


class TestSparseTopology:
    def test_ring_csr_matches_dense_ring(self):
        for n, k in ((8, 1), (9, 2), (16, 3)):
            g = topo.ring_graph(n, k=k)
            csr = topo.ring_graph_csr(n, k=k)
            want = topo.csr_from_graph(g)
            np.testing.assert_array_equal(csr.indptr, want.indptr)
            np.testing.assert_array_equal(csr.indices, want.indices)
            csr.validate()
            ref = ref_topo.ring_graph_csr(n, k=k)
            np.testing.assert_array_equal(csr.indptr, ref.indptr)
            np.testing.assert_array_equal(csr.indices, ref.indices)
            assert (csr.n, csr.num_edges, csr.max_degree, csr.name) == \
                (ref.n, ref.num_edges, ref.max_degree, ref.name)
            assert topo.edge_list(g) == ref_topo.edge_list(
                ref_topo.ring_graph(n, k=k))
        with pytest.raises(ValueError, match="2k < n"):
            topo.ring_graph_csr(4, 2)

    def test_sparse_graph_validation(self):
        with pytest.raises(ValueError, match="out of range"):
            topo.SparseGraph(np.array([0, 1]), np.array([1]))  # n=1, nbr 1
        with pytest.raises(ValueError, match="indptr"):
            topo.SparseGraph(np.array([1, 0]), np.array([]))
        g = topo.SparseGraph(np.array([0, 1, 2]), np.array([1, 0]))
        g.validate()
        with pytest.raises(ValueError, match="self-loop"):
            topo.SparseGraph(np.array([0, 1, 2]),
                             np.array([0, 0])).validate()
        with pytest.raises(ValueError, match="symmetric"):
            topo.SparseGraph(np.array([0, 1, 1, 1]),
                             np.array([1])).validate()  # asymmetric

    def test_induced_subgraph_matches_dense(self):
        g = topo.geographic_graph(12, 0.6, seed=2)
        ids = np.array([1, 3, 4, 9, 11])
        sub = topo.induced_subgraph(topo.csr_from_graph(g), ids)
        np.testing.assert_array_equal(
            sub.adjacency, g.adjacency[np.ix_(ids, ids)])
        # dense-graph input path
        sub2 = topo.induced_subgraph(g, ids)
        np.testing.assert_array_equal(sub2.adjacency, sub.adjacency)
        # an unsorted cohort keeps its order, as the reference's does
        perm = np.array([9, 1, 11, 4, 3])
        ref_g = ref_topo.geographic_graph(12, 0.6, seed=2)
        np.testing.assert_array_equal(
            topo.induced_subgraph(g, perm).adjacency,
            ref_topo.induced_subgraph(ref_topo.csr_from_graph(ref_g),
                                      perm).adjacency)

    def test_induced_subgraph_requires_unique_ids(self):
        g = topo.ring_graph_csr(8, 1)
        with pytest.raises(ValueError, match="unique"):
            topo.induced_subgraph(g, np.array([1, 1, 2]))

    def test_metropolis_csr_matches_dense(self):
        g = topo.geographic_graph(10, 0.6, seed=1)
        csr = topo.csr_from_graph(g)
        vals, diag = topo.metropolis_weights_csr(csr)
        w = topo.metropolis_weights(g)
        np.testing.assert_allclose(diag, np.diagonal(w))
        for i in range(10):
            js = csr.indices[csr.indptr[i]:csr.indptr[i + 1]]
            np.testing.assert_allclose(
                vals[csr.indptr[i]:csr.indptr[i + 1]], w[i, js])
        ref_vals, ref_diag = ref_topo.metropolis_weights_csr(
            ref_topo.csr_from_graph(ref_topo.geographic_graph(10, 0.6,
                                                              seed=1)))
        np.testing.assert_array_equal(vals, ref_vals)
        np.testing.assert_array_equal(diag, ref_diag)

    def test_lambda2_sparse_matches_dense(self):
        for maker, ref_maker in (
                (lambda: topo.ring_graph(12, k=2),
                 lambda: ref_topo.ring_graph(12, k=2)),
                (lambda: topo.geographic_graph(14, 0.6, seed=3),
                 lambda: ref_topo.geographic_graph(14, 0.6, seed=3))):
            g = maker()
            want = topo.lambda2(topo.metropolis_weights(g))
            got = topo.lambda2_sparse(topo.csr_from_graph(g))
            assert got == pytest.approx(want, abs=1e-6)
            assert got == ref_topo.lambda2_sparse(
                ref_topo.csr_from_graph(ref_maker()))

    def test_dense_size_guard(self):
        with pytest.raises(ValueError, match="n_dense_max") as err:
            topo.check_dense_size(5000, "test matrix")
        with pytest.raises(ValueError) as ref_err:
            ref_topo.check_dense_size(5000, "test matrix")
        assert str(err.value) == str(ref_err.value)
        topo.check_dense_size(5000, "test matrix", n_dense_max=10_000)
        with pytest.raises(ValueError, match="n_dense_max"):
            topo.metropolis_weights(topo.ring_graph(12, 1), n_dense_max=10)


class TestStalenessTilt:
    def test_beta_zero_is_bitwise_identity(self):
        w = topo.metropolis_weights(topo.ring_graph(8, 1))
        out = mixing_lib.staleness_tilted_weights(w, np.arange(8), 0.0)
        assert out is w

    def test_rows_still_sum_to_one(self):
        w = topo.metropolis_weights(topo.geographic_graph(9, 0.6, seed=4))
        ages = np.array([0, 1, 5, 0, 2, 10, 0, 3, 7])
        out = mixing_lib.staleness_tilted_weights(w, ages, 0.5)
        np.testing.assert_allclose(out.sum(axis=1), np.ones(9), atol=1e-12)
        # stale agents' columns are down-weighted off-diagonal
        assert out[0, 5] < w[0, 5] or w[0, 5] == 0.0
        np.testing.assert_array_equal(
            out, ref_mixing.staleness_tilted_weights(w, ages, 0.5))

    def test_validation(self):
        w = topo.metropolis_weights(topo.ring_graph(4, 1))
        with pytest.raises(ValueError, match="staleness"):
            mixing_lib.staleness_tilted_weights(w, np.zeros(4), -0.1)
        with pytest.raises(ValueError, match="ages"):
            mixing_lib.staleness_tilted_weights(w, np.zeros(3), 1.0)


def test_sample_metropolis_traced_is_the_reference_on_its_uniforms():
    """``mixing.sample_metropolis_traced`` (metropolis_from_uniforms) on
    the uniforms that the reference draws from its key gives the
    reference's W^t."""
    g = topo.geographic_graph(9, 0.6, seed=5)
    key = jax.random.key(11)
    u = np.array(jax.random.uniform(key, (9, 9)))
    want = np.asarray(ref_mixing.sample_metropolis_traced(
        key, jnp.asarray(g.adjacency), 0.3, jnp.float32))
    got = mixing_lib.sample_metropolis_traced(
        torch.from_numpy(u), torch.from_numpy(g.adjacency), 0.3,
        torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert mixing_lib.sample_metropolis_traced is \
        mixing_lib.metropolis_from_uniforms


# ---------------------------------------------------------------------------
# The cohort ELL tables: exactly the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("staleness", [0.0, 0.5])
def test_cohort_mix_tables_equal_the_reference(staleness):
    g = topo.ring_graph_csr(40, 2)
    ref_g = ref_topo.ring_graph_csr(40, 2)
    ids = np.array([0, 1, 2, 5, 6, 7, 20, 21, 38, 39])
    ages = np.arange(10) % 4
    kw = dict(n_total=40, cohort_size=10, staleness=staleness, max_degree=5,
              n_clusters=3)
    mix = pop.build_cohort_mix(g, ids, pop.PopulationSpec(**kw), ages=ages)
    ref = ref_pop.build_cohort_mix(ref_g, ids, ref_pop.PopulationSpec(**kw),
                                   ages=ages)
    for name in ("nbr", "wv", "diag", "cluster"):
        got, want = getattr(mix, name).numpy(), np.asarray(getattr(ref,
                                                                   name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the contiguous cluster blocks the two-tier server sums
    assert mix.segments == ((0, 6), (6, 8), (8, 10))
    x = np.random.default_rng(0).standard_normal((10, 7)).astype(np.float32)
    np.testing.assert_allclose(
        pop.cohort_gossip(mix, torch.from_numpy(x)).numpy(),
        np.asarray(ref_pop._ell_mix(ref, jnp.asarray(x))),
        rtol=0, atol=1e-6 * np.abs(x).max())


# ---------------------------------------------------------------------------
# The engine: bit-identity, overlap ≡ sync, hierarchy, against the reference
# ---------------------------------------------------------------------------


N_EQ, H_EQ, K_EQ, ROUNDS_EQ = 12, 4, 3, 2
LR = 1e-3


@pytest.fixture(scope="module")
def eq_problem():
    return linreg.make_problem(n=N_EQ, seed=0)


def _round_batches(problem, rounds: int, c: int, h: int = H_EQ, m: int = 2,
                   seed: int = 3) -> list:
    """Per-round numpy minibatches (x (h, c, m, d), y (h, c, m)) in f32,
    agent i's rows from problem agent i mod n."""
    rng = np.random.default_rng(seed)
    agents = np.arange(c) % problem.n
    out = []
    for _ in range(rounds):
        idx = rng.integers(0, problem.m_rows, (h, c, m))
        out.append((problem.x[agents[None, :, None], idx].astype(np.float32),
                    problem.y[agents[None, :, None], idx].astype(np.float32)))
    return out


def _lr_fn(_t):
    return torch.full((1,), LR)


def _port_engine(problem, n_total, cohort, graph, *, h=H_EQ, k=K_EQ,
                 row=None, **spec_kw):
    spec = pop.PopulationSpec(n_total, cohort, **spec_kw)
    fspec = flat_lib.make_flat_spec({"z": torch.zeros(problem.d)})
    row = np.zeros(problem.d, np.float32) if row is None else row
    return pop.PopulationEngine(spec, fspec, linreg.make_grad_fn(10),
                                _lr_fn, graph, h=h, k=k, device="cpu",
                                row_init=row)


def _ref_engine(problem, n_total, cohort, graph, *, h=H_EQ, k=K_EQ,
                row=None, **spec_kw):
    spec = ref_pop.PopulationSpec(n_total, cohort, **spec_kw)
    fspec = ref_flat.make_flat_spec(jnp.zeros(problem.d))
    row = np.zeros(problem.d, np.float32) if row is None else row
    return ref_pop.PopulationEngine(
        spec, fspec, ref_linreg.make_grad_fn(10),
        lambda t: jnp.float32(LR), graph, h=h, k=k, row_init=row)


def _run_both(problem, batches, n_rounds, *, n_total, cohort, graph,
              ref_graph, key_seed=7, overlap=True, cut=None, **kw):
    """The port's and the reference's engine over the same batches (cut
    to the cohort with ``cut``) and replayed server draws: (port engine,
    reference engine, port metrics)."""
    cut = cut or cohort

    def port_fn(r, ids):
        x, y = batches[r]
        return {"x": torch.from_numpy(x[:, :cut]),
                "y": torch.from_numpy(y[:, :cut])}

    def ref_fn(r, ids):
        x, y = batches[r]
        return jnp.asarray(x[:, :cut]), jnp.asarray(y[:, :cut])

    key = jax.random.key(key_seed)
    eng = _port_engine(problem, n_total, cohort, graph, **kw)
    mets = eng.run(n_rounds, port_fn, ReplayDraws(key), overlap=overlap)
    ref = _ref_engine(problem, n_total, cohort, ref_graph, **kw)
    ref.run(n_rounds, ref_fn, key, overlap=overlap)
    return eng, ref, mets


def _assert_close_to_ref(eng, ref):
    got = eng.store.gather(np.arange(eng.spec.n_total))
    want = ref.store.gather(np.arange(eng.spec.n_total))
    scale = np.abs(want).max()
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    np.testing.assert_array_equal(eng.store.last_round, ref.store.last_round)


class TestEngine:
    def test_bit_identical_to_flat_sparse_when_cohort_is_population(
            self, eq_problem):
        graph = topo.geographic_graph(N_EQ, 0.5, seed=1)
        ref_graph = ref_topo.geographic_graph(N_EQ, 0.5, seed=1)
        batches = _round_batches(eq_problem, ROUNDS_EQ, N_EQ)
        key = jax.random.key(7)
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(eq_problem.d)})
        fcfg = FedDecConfig(
            mixing=MixingDistribution(graph, p_fail=0.0,
                                      scheme="metropolis"),
            h=H_EQ, k=K_EQ, gossip_impl="sparse")
        flat_round = flat_lib.make_flat_feddec_round(
            fcfg, fspec, linreg.make_grad_fn(10), _lr_fn, device="cpu")
        st = flat_lib.init_flat_state(fspec, {"z": torch.zeros(
            eq_problem.d)}, N_EQ)
        for r in range(ROUNDS_EQ):
            x, y = batches[r]
            st, _ = flat_round(st, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)},
                               ReplayDraws(key))
        eng, ref, _ = _run_both(
            eq_problem, batches, ROUNDS_EQ, n_total=N_EQ, cohort=N_EQ,
            graph=topo.csr_from_graph(graph),
            ref_graph=ref_topo.csr_from_graph(ref_graph),
            max_degree=int(graph.degrees.max()))
        got = eng.store.gather(np.arange(N_EQ))
        np.testing.assert_array_equal(got, st.flat.numpy())
        _assert_close_to_ref(eng, ref)
        # the reference's own anchor, for the record: its flat sparse
        # engine on the same batches
        rcfg = RefFedDecConfig(
            mixing=RefMixing(ref_graph, p_fail=0.0, scheme="metropolis"),
            h=H_EQ, k=K_EQ, gossip_impl="sparse")
        rfspec = ref_flat.make_flat_spec(jnp.zeros(eq_problem.d))
        rround = ref_flat.make_flat_feddec_round(
            rcfg, rfspec, ref_linreg.make_grad_fn(10),
            lambda t: jnp.float32(LR), donate=False)
        rst = ref_flat.init_flat_state(rfspec, jnp.zeros(eq_problem.d), N_EQ)
        for r in range(ROUNDS_EQ):
            rst, _ = rround(rst, tuple(map(jnp.asarray, batches[r])), key)
        np.testing.assert_array_equal(
            ref.store.gather(np.arange(N_EQ)), np.asarray(rst.flat))

    def test_overlap_equals_sync_trajectory(self, eq_problem):
        batches = _round_batches(eq_problem, 6, 8)
        stores, drains = {}, {}
        for overlap in (False, True):
            eng, ref, mets = _run_both(
                eq_problem, batches, 6, n_total=64, cohort=8,
                graph=topo.ring_graph_csr(64, 2),
                ref_graph=ref_topo.ring_graph_csr(64, 2), key_seed=0,
                overlap=overlap, k=2, max_degree=4, seed=3)
            stores[overlap] = eng.store.gather(np.arange(64))
            drains[overlap] = mets["drains"]
            _assert_close_to_ref(eng, ref)
        np.testing.assert_array_equal(stores[True], stores[False])
        assert drains[True] == drains[False]

    def test_singleton_clusters_match_flat_server(self, eq_problem):
        """n_clusters == n_total == cohort: tier-1 averaging is the
        identity (every cluster is one agent) and the hierarchical round
        must be bit-identical to the plain server round."""
        graph = topo.csr_from_graph(topo.geographic_graph(N_EQ, 0.5,
                                                          seed=1))
        ref_graph = ref_topo.csr_from_graph(ref_topo.geographic_graph(
            N_EQ, 0.5, seed=1))
        batches = _round_batches(eq_problem, ROUNDS_EQ, N_EQ)
        outs = {}
        for n_clusters in (0, N_EQ):
            eng, ref, _ = _run_both(
                eq_problem, batches, ROUNDS_EQ, n_total=N_EQ, cohort=N_EQ,
                graph=graph, ref_graph=ref_graph, n_clusters=n_clusters,
                max_degree=graph.max_degree)
            outs[n_clusters] = eng.store.gather(np.arange(N_EQ))
            _assert_close_to_ref(eng, ref)
        np.testing.assert_array_equal(outs[0], outs[N_EQ])

    def test_hierarchical_mode_runs_and_stays_finite(self, eq_problem):
        graph = topo.csr_from_graph(topo.geographic_graph(N_EQ, 0.5,
                                                          seed=1))
        ref_graph = ref_topo.csr_from_graph(ref_topo.geographic_graph(
            N_EQ, 0.5, seed=1))
        batches = _round_batches(eq_problem, ROUNDS_EQ, N_EQ)
        eng, ref, _ = _run_both(
            eq_problem, batches, ROUNDS_EQ, n_total=N_EQ, cohort=N_EQ,
            graph=graph, ref_graph=ref_graph, n_clusters=3,
            max_degree=graph.max_degree)
        rows = eng.store.gather(np.arange(N_EQ))
        assert np.isfinite(rows).all()
        assert np.abs(rows).sum() > 0.0
        _assert_close_to_ref(eng, ref)

    def test_staleness_mode_runs(self, eq_problem):
        batches = _round_batches(eq_problem, 4, 6, seed=5)
        eng, ref, _ = _run_both(
            eq_problem, batches, 4, n_total=32, cohort=6,
            graph=topo.ring_graph_csr(32, 1),
            ref_graph=ref_topo.ring_graph_csr(32, 1), key_seed=0, k=2,
            sampling="stale", staleness=0.5, max_degree=2, seed=1)
        assert np.isfinite(eng.store.rows).all()
        # every cohort was marked: 4 rounds × 6 agents, maybe overlapping
        assert (eng.store.last_round >= 0).sum() <= 24
        _assert_close_to_ref(eng, ref)

    def test_max_degree_guard_raises(self):
        graph = topo.geographic_graph(N_EQ, 0.9, seed=1)  # dense-ish
        spec = pop.PopulationSpec(N_EQ, N_EQ, max_degree=1)
        with pytest.raises(ValueError, match="max_degree") as err:
            pop.build_cohort_mix(topo.csr_from_graph(graph),
                                 np.arange(N_EQ), spec)
        with pytest.raises(ValueError) as ref_err:
            ref_pop.build_cohort_mix(
                ref_topo.csr_from_graph(ref_topo.geographic_graph(
                    N_EQ, 0.9, seed=1)), np.arange(N_EQ),
                ref_pop.PopulationSpec(N_EQ, N_EQ, max_degree=1))
        assert str(err.value) == str(ref_err.value)

    def test_optimizer_not_streamed(self, eq_problem):
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(eq_problem.d)})
        with pytest.raises(NotImplementedError, match="optimizer"):
            pop.PopulationEngine(
                pop.PopulationSpec(8, 4), fspec,
                linreg.make_grad_fn(10), _lr_fn, topo.ring_graph_csr(8, 1),
                h=2, k=2, optimizer=object(), device="cpu",
                row_init=np.zeros(eq_problem.d, np.float32))

    def test_engine_checks_are_the_reference_messages(self, eq_problem):
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(eq_problem.d)})
        ref_fspec = ref_flat.make_flat_spec(jnp.zeros(eq_problem.d))
        cases = [
            # graph n != n_total
            (dict(spec=(9, 4), graph=8, store_d=None), ValueError),
            # D mismatch
            (dict(spec=(8, 4), graph=8, store_d=3), ValueError),
            # neither store nor row_init
            (dict(spec=(8, 4), graph=8, store_d=None, no_row=True),
             ValueError)]
        for case, exc in cases:
            errs = []
            for mod, fs, tp in ((pop, fspec, topo), (ref_pop, ref_fspec,
                                                     ref_topo)):
                store = None if case["store_d"] is None else \
                    mod.PopulationStore.create(8, np.zeros(case["store_d"]))
                row = None if case.get("no_row") or store is not None \
                    else np.zeros(eq_problem.d, np.float32)
                kw = {"device": "cpu"} if mod is pop else {}
                with pytest.raises(exc) as err:
                    mod.PopulationEngine(
                        mod.PopulationSpec(*case["spec"]), fs,
                        None, None, tp.ring_graph_csr(case["graph"], 1),
                        h=2, k=2, store=store, row_init=row, **kw)
                errs.append(str(err.value))
            assert errs[0] == errs[1]

    def test_make_population_round_is_the_cohort_round(self, eq_problem):
        """engine.make_population_round is the shim the reference has: one
        round of it on the identity cohort equals the engine's."""
        graph = topo.ring_graph_csr(8, 1)
        spec = pop.PopulationSpec(8, 8, max_degree=2)
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(eq_problem.d)})
        x, y = _round_batches(eq_problem, 1, 8)[0]
        batches = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        round_fn = engine.make_population_round(
            spec, fspec, linreg.make_grad_fn(10), _lr_fn, h=H_EQ, k=2,
            device="cpu")
        mix = pop.build_cohort_mix(graph, np.arange(8), spec)
        state = flat_lib.FlatFedState(flat=torch.zeros(8, eq_problem.d),
                                      step=1)
        key = jax.random.key(2)
        state, mets = round_fn(state, batches, ReplayDraws(key), mix)
        assert state.step == 1 + H_EQ and mets["loss"].shape == (H_EQ,)
        eng = _port_engine(eq_problem, 8, 8, graph, k=2, max_degree=2)
        eng.run(1, lambda r, ids: batches, ReplayDraws(key))
        np.testing.assert_array_equal(eng.store.gather(np.arange(8)),
                                      state.flat.numpy())

    def test_runs_on_cuda_by_default(self, eq_problem):
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(eq_problem.d)})
        args = (pop.PopulationSpec(8, 4), fspec, linreg.make_grad_fn(10),
                _lr_fn, topo.ring_graph_csr(8, 1))
        kw = dict(h=2, k=2, row_init=np.zeros(eq_problem.d, np.float32))
        if torch.cuda.is_available():
            assert pop.PopulationEngine(*args, **kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pop.PopulationEngine(*args, **kw)


# ---------------------------------------------------------------------------
# The cost model (launch/analysis.population_cost_model): the reference's
# ---------------------------------------------------------------------------


class TestCostModel:
    def test_peak_device_bytes_has_no_n_total_term(self):
        peaks = {
            analysis.population_cost_model(
                n_total=n, cohort_size=256, d=25, max_degree=4,
                h=10)["peak_device_bytes"]
            for n in (10**4, 10**5, 10**6)}
        assert len(peaks) == 1

    def test_host_store_scales_with_n_total(self):
        small, big = (analysis.population_cost_model(
            n_total=n, cohort_size=64, d=10, max_degree=4, h=5)
            for n in (1000, 2000))
        assert big["host_store_bytes"] == 2 * small["host_store_bytes"]
        assert big["upload_bytes_round"] == small["upload_bytes_round"]

    def test_transfer_time_uses_bandwidth(self):
        m = analysis.population_cost_model(
            n_total=100, cohort_size=10, d=8, max_degree=2, h=3,
            h2d_bw=1e6)
        assert m["transfer_us_round"] == pytest.approx(
            m["hostdev_bytes_round"] / 1e6 * 1e6)

    @pytest.mark.parametrize("kw", [
        dict(n_total=10**6, cohort_size=256, d=25, max_degree=4, h=10),
        dict(n_total=16, cohort_size=8, d=156_519_168, max_degree=4, h=10,
             param_bytes=4, idx_bytes=4, counter_bytes=8, h2d_bw=25e9)])
    def test_equals_the_reference(self, kw):
        assert analysis.population_cost_model(**kw) == \
            ref_analysis.population_cost_model(**kw)
        assert analysis.H2D_BW == ref_analysis.H2D_BW


class TestLaunch:
    def test_population_graph_parses_ring(self):
        from repro.launch.train import population_graph as ref_graph
        from repro_torch.launch.train import population_graph
        g = population_graph("ring2", 64)
        assert isinstance(g, topo.SparseGraph)
        assert g.max_degree == 4
        np.testing.assert_array_equal(g.indices,
                                      ref_graph("ring2", 64).indices)
        with pytest.raises(ValueError, match="ring") as err:
            population_graph("geographic", 64)
        with pytest.raises(ValueError) as ref_err:
            ref_graph("geographic", 64)
        assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# tests/test_delta.py::TestPopulationIntegration
# ---------------------------------------------------------------------------


class TestPopulationIntegration:
    def test_population_engine_with_delta_store(self):
        """The cohort engine over a DeltaStore(full) backend matches the
        dense-store engine bit for bit (a storage format, not an
        algorithm), and the reference's within TOL·max|x|."""
        n_total, c, d, h = 32, 8, 12, 2
        prob = linreg.make_problem(n=c, m_rows=4, d=d, seed=1)
        batches = _round_batches(prob, 3, c, h=h, seed=8)
        row0 = np.random.default_rng(20).standard_normal(d).astype(
            np.float32)
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(d)})
        ref_fspec = ref_flat.make_flat_spec(jnp.zeros(d))
        key = jax.random.key(0)
        outs, ref_outs = [], []
        for delta in ("none", "full"):
            eng = pop.PopulationEngine(
                pop.PopulationSpec(n_total, c, max_degree=2, seed=3), fspec,
                linreg.make_grad_fn(4), _lr_fn, topo.ring_graph_csr(n_total,
                                                                    1),
                h=h, k=2, device="cpu", row_init=row0, delta=delta)
            assert isinstance(eng.store, DeltaStore) == (delta == "full")
            eng.run(3, lambda r, ids: {
                "x": torch.from_numpy(batches[r][0]),
                "y": torch.from_numpy(batches[r][1])}, ReplayDraws(key))
            outs.append(eng.store.gather(np.arange(n_total)))
            ref = ref_pop.PopulationEngine(
                ref_pop.PopulationSpec(n_total, c, max_degree=2, seed=3),
                ref_fspec, ref_linreg.make_grad_fn(4),
                lambda t: jnp.float32(LR), ref_topo.ring_graph_csr(n_total,
                                                                   1),
                h=h, k=2, row_init=row0, delta=delta)
            ref.run(3, lambda r, ids: tuple(map(jnp.asarray, batches[r])),
                    key)
            ref_outs.append(ref.store.gather(np.arange(n_total)))
        np.testing.assert_array_equal(outs[0], outs[1])
        for got, want in zip(outs, ref_outs):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=TOL * np.abs(want).max())

    def test_population_engine_rejects_mismatched_store(self):
        n_total, c, d = 16, 4, 8
        fspec = flat_lib.make_flat_spec({"z": torch.zeros(d)})
        dense = pop.PopulationStore.create(n_total, np.zeros(d, np.float32))
        with pytest.raises(ValueError, match="DeltaStore") as err:
            pop.PopulationEngine(pop.PopulationSpec(n_total, c, max_degree=2),
                                 fspec, linreg.make_grad_fn(4), _lr_fn,
                                 topo.ring_graph_csr(n_total, 1), h=2, k=2,
                                 device="cpu", store=dense, delta="topk:4")
        with pytest.raises(ValueError) as ref_err:
            ref_pop.PopulationEngine(
                ref_pop.PopulationSpec(n_total, c, max_degree=2),
                ref_flat.make_flat_spec(jnp.zeros(d)),
                ref_linreg.make_grad_fn(4), lambda t: 1e-3,
                ref_topo.ring_graph_csr(n_total, 1), h=2, k=2,
                store=ref_pop.PopulationStore.create(
                    n_total, np.zeros(d, np.float32)), delta="topk:4")
        assert str(err.value) == str(ref_err.value)
