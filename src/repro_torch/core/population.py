"""Million-agent population engine: cohort-sampled FedDec over a host
store streamed to the card (repro/core/population.py).

Algorithm 1's server already assumes partial participation (K sampled
agents a round); this layer makes n_total ≫ the agents on the device
first-class:

* the **population store** is an ``np.memmap``-backed (n_total, D) row
  file on the host, with each agent's last-participation round, so
  n_total = 1e6 is never whole on the device or in host memory;
* each round samples a **cohort** of ``cohort_size`` ids (uniform,
  weighted or stale-first) with numpy's Generator exactly as the
  reference does (so both packages draw the same ids from one seed),
  uploads their rows, runs the flat engine's H-step round on the cohort
  buffer (the same ``engine.build_step_body`` every engine runs) and
  writes the rows back;
* the mixing is rebuilt every round on the sampled subgraph only
  (:func:`topology.induced_subgraph`, never an (n_total, n_total) W):
  Metropolis weights, optionally tilted by each agent's participation age
  (:func:`mixing.staleness_tilted_weights`), as padded ELL tables;
* uploads and write-backs are **double-buffered** on the card: round r+1's
  rows are gathered into pinned host memory and copied on a second CUDA
  stream while round r runs, and round r−1's rows come back on that
  stream as soon as round r−1 is done.  A drain serializes the rounds
  whose cohort meets the one in flight, so ``overlap=True`` and
  ``overlap=False`` give the same trajectory bit for bit.

The cohort mix is kernel #2 (``kernels.ops.gossip_mix_sparse``), not a
copy of the reference's plain ``_ell_mix``: with ``n_total ==
cohort_size`` and uniform sampling the cohort is the identity slice, the
induced subgraph is the whole graph and the tables are the flat sparse
engine's entry for entry, so the population trajectory equals the flat
engine's under ``gossip_impl='sparse'`` bit for bit, and on the card that
engine mixes through #2.  Peak device memory is bounded by the cohort,
with no n_total term.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import flat as flat_lib
from repro_torch.core import mixing as mixing_lib
from repro_torch.core import server as server_lib
from repro_torch.core import topology as topo
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.flat import FlatFedState, FlatSpec

__all__ = ["SAMPLINGS", "PopulationSpec", "PopulationStore", "CohortMix",
           "sample_cohort", "build_cohort_mix", "cohort_gossip",
           "make_cohort_round", "PopulationEngine"]

SAMPLINGS = ("uniform", "weighted", "stale")

LrFn = Callable[[int], torch.Tensor]


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Static configuration of the population layer.

    Attributes:
      n_total: population size (agents in the host store).
      cohort_size: agents uploaded and trained a round.
      sampling: 'uniform' (without replacement), 'weighted' (∝ the
        engine's per-agent weights) or 'stale' (∝ 1 + participation age).
      staleness: the FedPAE age tilt β of the cohort W; 0 keeps plain
        Metropolis weights, bit for bit.
      max_degree: the ELL width of the cohort tables (a cohort subgraph of
        larger degree raises).
      n_clusters: > 1 turns on the two-tier server round: averaging in
        contiguous id blocks before the K-sample server round.
      seed: the host RNG seed of the cohort sampler.
    """

    n_total: int
    cohort_size: int
    sampling: str = "uniform"
    staleness: float = 0.0
    max_degree: int = 8
    n_clusters: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.n_total < 1:
            raise ValueError(f"n_total must be ≥ 1, got {self.n_total}")
        if not 1 <= self.cohort_size <= self.n_total:
            raise ValueError(
                f"cohort_size must be in [1, n_total={self.n_total}], "
                f"got {self.cohort_size}")
        if self.sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {self.sampling!r}; choose "
                             f"from {'|'.join(SAMPLINGS)}")
        if self.staleness < 0.0:
            raise ValueError(f"staleness must be ≥ 0, got {self.staleness}")
        if self.max_degree < 1:
            raise ValueError(f"max_degree must be ≥ 1, got {self.max_degree}")
        if self.n_clusters > self.cohort_size:
            raise ValueError(
                f"n_clusters ({self.n_clusters}) cannot exceed cohort_size "
                f"({self.cohort_size})")

    def cluster_of(self, ids: np.ndarray) -> np.ndarray:
        """Contiguous-block edge-cluster assignment of population ids."""
        m = max(self.n_clusters, 1)
        return ((np.asarray(ids, dtype=np.int64) * m)
                // self.n_total).astype(np.int32)


# ---------------------------------------------------------------------------
# The host store (memmap; n_total never on the device whole)
# ---------------------------------------------------------------------------


class PopulationStore:
    """(n_total, D) host row store and each agent's last scheduled round.

    ``rows[i]`` is Algorithm 1's z_i for population agent i, in a
    file-backed ``np.memmap``, so only gathered cohorts occupy process
    memory; ``last_round[i]`` is the last round agent i was scheduled
    into (−1: never), which the 'stale' sampler and the age tilt read.
    """

    def __init__(self, rows: np.ndarray, last_round: np.ndarray,
                 path: str | None = None):
        rows = np.asarray(rows) if not isinstance(rows, np.memmap) else rows
        if rows.ndim != 2:
            raise ValueError(f"rows must be (n_total, D), got {rows.shape}")
        if last_round.shape != (rows.shape[0],):
            raise ValueError(
                f"last_round must be ({rows.shape[0]},), "
                f"got {last_round.shape}")
        self.rows = rows
        self.last_round = np.asarray(last_round, dtype=np.int64)
        self.path = path

    @property
    def n_total(self) -> int:
        return self.rows.shape[0]

    @property
    def d(self) -> int:
        return self.rows.shape[1]

    @property
    def nbytes(self) -> int:
        """Live host bytes: the rows and the staleness counters."""
        return int(self.rows.nbytes + self.last_round.nbytes)

    @classmethod
    def create(cls, n_total: int, row_init: np.ndarray,
               path: str | None = None, dtype=np.float32,
               chunk_rows: int = 65536) -> "PopulationStore":
        """z_i^1 = z^1 ∀i (Alg. 1 line 1) as a memmap, written in chunks.

        ``path=None`` backs the store with an unlinked temporary file (the
        memmap keeps its handle), so no run holds (n_total, D) in memory.
        """
        row = np.asarray(row_init, dtype=dtype).reshape(-1)
        d = row.shape[0]
        if path is None:
            f = tempfile.NamedTemporaryFile(
                prefix="population_", suffix=".rows")
            rows = np.memmap(f, dtype=dtype, mode="w+", shape=(n_total, d))
            rows._tmpfile = f  # keep the unlinked handle alive
        else:
            rows = np.memmap(path, dtype=dtype, mode="w+",
                             shape=(n_total, d))
        for lo in range(0, n_total, chunk_rows):
            hi = min(lo + chunk_rows, n_total)
            rows[lo:hi] = row[None, :]
        last_round = np.full((n_total,), -1, dtype=np.int64)
        return cls(rows, last_round, path=path)

    def gather(self, ids: np.ndarray, out: np.ndarray | None = None
               ) -> np.ndarray:
        """Cohort rows, a copy (the host side of the upload); into
        ``out`` (e.g. a pinned staging buffer) when given."""
        ids = np.asarray(ids)
        if out is None:
            return np.array(self.rows[ids])
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_total):
            raise IndexError(f"ids out of range for n_total={self.n_total}")
        # mode 'clip' (the ids are checked): 'raise' would stage the rows
        # in a temporary before copying them into ``out``
        return np.take(self.rows, ids, axis=0, out=out, mode="clip")

    def scatter(self, ids: np.ndarray, values: np.ndarray) -> None:
        """Write a finished cohort back (the host side of the download)."""
        self.rows[np.asarray(ids)] = np.asarray(
            values, dtype=self.rows.dtype)

    def ages(self, ids: np.ndarray, round_idx: int) -> np.ndarray:
        """Participation age (rounds since last scheduled; never < 0)."""
        return np.maximum(
            round_idx - self.last_round[np.asarray(ids)], 0)

    # -- checkpointing (chunked; repro_torch.checkpoint) --------------------

    def save(self, directory: str, step: int) -> str:
        """Stream the rows and the counters to ``<directory>/pop_<step>/``
        (the reference's format; needs no zstandard)."""
        from repro_torch.checkpoint import save_population
        return save_population(directory, step, self.rows, self.last_round)

    @classmethod
    def restore(cls, directory: str, step: int | None = None, *,
                writable_path: str | None = None) -> "PopulationStore":
        """A store rebuilt from a checkpoint (the latest when ``step`` is
        None), its rows copied into a new writable memmap (a temporary
        file, or ``writable_path``)."""
        from repro_torch.checkpoint import load_population
        rows, last_round, meta = load_population(directory, step)
        store = cls.create(meta["n_total"], np.zeros(meta["d"], rows.dtype),
                           path=writable_path, dtype=rows.dtype)
        chunk = 65536
        for lo in range(0, meta["n_total"], chunk):
            store.rows[lo:lo + chunk] = rows[lo:lo + chunk]
        store.last_round[:] = last_round
        return store


# ---------------------------------------------------------------------------
# Cohort sampling (host, numpy RNG)
# ---------------------------------------------------------------------------


def sample_cohort(rng: np.random.Generator, spec: PopulationSpec,
                  last_round: np.ndarray, round_idx: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """One round's cohort ids, sorted ascending.

    Sorted ids give memmap gather locality and make the n_total ==
    cohort_size uniform cohort the identity slice (the anchor against the
    flat engine).  'weighted' and 'stale' use Gumbel top-k: sampling
    without replacement ∝ the weights in one O(n_total) pass.  The draws
    are the reference's, call for call.
    """
    n, c = spec.n_total, spec.cohort_size
    if spec.sampling == "uniform":
        ids = rng.choice(n, size=c, replace=False)
    else:
        if spec.sampling == "weighted":
            if weights is None:
                raise ValueError(
                    "sampling='weighted' needs a per-agent weights vector")
            w = np.asarray(weights, dtype=np.float64)
            if w.shape != (n,) or np.any(w < 0) or w.sum() <= 0:
                raise ValueError(
                    f"weights must be (n_total,) ≥ 0 with a positive sum, "
                    f"got shape {w.shape}")
        else:  # 'stale': agents longest out of a cohort first
            w = 1.0 + np.maximum(round_idx - last_round, 0).astype(np.float64)
        with np.errstate(divide="ignore"):
            gumbel = np.log(w) + rng.gumbel(size=n)
        ids = np.argpartition(-gumbel, c - 1)[:c]
    return np.sort(ids).astype(np.int64)


# ---------------------------------------------------------------------------
# The per-round cohort mix tables (subgraph Metropolis, ELL)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CohortMix:
    """One cohort's mixing tables, in the flat sparse engine's padded ELL
    layout: padded slots point at the row's own agent with weight 0, so
    they add exact +0.0.

    ``segments`` are the host-side [lo, hi) row blocks of the edge
    clusters (contiguous, since the ids are sorted and ``cluster_of`` is
    monotone), which the two-tier server sums in a fixed order.
    """

    nbr: torch.Tensor      # (c, max_degree) int32, padding = own row
    wv: torch.Tensor       # (c, max_degree), padding = 0.0
    diag: torch.Tensor     # (c,)
    cluster: torch.Tensor  # (c,) int32, the tier-1 assignment
    segments: tuple = ()

    def tensors(self) -> tuple:
        return self.nbr, self.wv, self.diag, self.cluster


def _cohort_tables(graph, ids: np.ndarray, spec: PopulationSpec,
                   ages: np.ndarray | None, dtype) -> dict:
    """The numpy tables of :func:`build_cohort_mix`, as the reference
    builds them (repro/core/population.py:290-334)."""
    sub = topo.induced_subgraph(graph, ids)
    c = sub.n
    max_deg_actual = int(sub.degrees.max()) if c else 0
    if max_deg_actual > spec.max_degree:
        raise ValueError(
            f"cohort subgraph degree {max_deg_actual} exceeds the static "
            f"ELL width max_degree={spec.max_degree}; raise "
            f"PopulationSpec.max_degree (graph family bound)")
    w = topo.metropolis_weights(sub)
    if spec.staleness > 0.0:
        if ages is None:
            raise ValueError("staleness > 0 needs per-cohort ages")
        w = mixing_lib.staleness_tilted_weights(w, ages, spec.staleness)
    adj = sub.adjacency
    nbr = np.tile(np.arange(c, dtype=np.int32)[:, None],
                  (1, spec.max_degree))
    wv = np.zeros((c, spec.max_degree), dtype=dtype)
    for i in range(c):
        js = np.flatnonzero(adj[i])
        nbr[i, :len(js)] = js
        wv[i, :len(js)] = w[i, js]
    diag = np.diagonal(w).astype(dtype)
    cluster = spec.cluster_of(ids)
    runs = np.flatnonzero(np.diff(cluster)) + 1
    bounds = np.concatenate([[0], runs, [c]]).tolist()
    segments = tuple(zip(bounds[:-1], bounds[1:]))
    if len(segments) != len(np.unique(cluster)):
        raise ValueError("the cohort's edge clusters are not contiguous row "
                         "blocks; pass the ids sorted ascending")
    return {"nbr": nbr, "wv": wv, "diag": diag, "cluster": cluster,
            "segments": segments}


def build_cohort_mix(graph: "topo.SparseGraph | topo.Graph",
                     ids: np.ndarray, spec: PopulationSpec,
                     ages: np.ndarray | None = None, dtype=np.float32,
                     device="cpu") -> CohortMix:
    """Metropolis mixing on the induced cohort subgraph, as ELL tables.

    Host numpy, never a dense (n_total, n_total) array: the subgraph comes
    from :func:`topology.induced_subgraph` (a CSR reindex) and only the
    (c, c) cohort W is dense.  ``spec.staleness > 0`` tilts W by the ages
    before the tables are read.  The tables are moved to ``device`` once.
    """
    return _to_mix(_cohort_tables(graph, ids, spec, ages, dtype), device)


def _to_mix(tables: dict, device, non_blocking: bool = False) -> CohortMix:
    return CohortMix(*(torch.as_tensor(tables[name]).to(
        device, non_blocking=non_blocking)
        for name in ("nbr", "wv", "diag", "cluster")),
        segments=tables["segments"])


def cohort_gossip(mix: CohortMix, x: torch.Tensor) -> torch.Tensor:
    """The cohort mix y_i = diag_i·x_i + Σ_k wv[i, k]·x[nbr[i, k]]:
    kernel #2 on CUDA, its plain version on the CPU (summing in f32, as
    #2 and the reference's kernel do), the flat sparse engine's mix on
    the same tables."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.gossip_mix_sparse(mix.nbr, mix.wv, mix.diag, x)


# ---------------------------------------------------------------------------
# The cohort round (the shared step body, the round's mix swapped in)
# ---------------------------------------------------------------------------


def _hierarchical_server(mix: CohortMix, h: int, k: int,
                         server_enabled: bool):
    """The two-tier server op: each edge cluster's rows replaced by their
    mean, then the paper's K-sample server round on that buffer
    (repro/core/population.py:378-400), in place.  The clusters are
    contiguous row blocks, summed one block at a time (no atomics), so
    two runs on the card agree bit for bit; a cluster of one agent keeps
    its row exactly (its sum over one row, divided by 1)."""
    def server(draws, t, x_next):
        if not server_enabled or (t + 1) % h:
            return x_next
        for lo, hi in mix.segments:        # tier 1: edge-cluster averages
            block = x_next[lo:hi]
            block.copy_((block.sum(dim=0) / (hi - lo)).expand_as(block))
        return server_lib.server_round_flat(draws, t, x_next, k)  # tier 2

    return server


def make_cohort_round(spec: PopulationSpec, flat_spec: FlatSpec,
                      grad_fn: engine.GradFn, lr_fn: LrFn, *, h: int,
                      k: int, device, server_enabled: bool = True,
                      optimizer=None, metrics_fn=None):
    """``round_fn(state, batches, draws, mix)`` for one cohort.

    The flat engine's H-step round, the same ``engine.build_step_body``
    vtable, on a carrier config (identity mixing over the cohort,
    ``gossip_impl='none'``) with three ops swapped: ``sample_w`` returns
    the round's :class:`CohortMix`, ``gossip`` is :func:`cohort_gossip`
    (kernel #2), and with ``spec.n_clusters > 1`` the server is the
    two-tier round.  The state passed in is donated, as in the flat
    engine: every round needs a FlatFedState of its own.
    """
    c = spec.cohort_size
    cfg = FedDecConfig(mixing=mixing_lib.identity_mixing(c), h=h, k=k,
                       server_enabled=server_enabled, gossip_impl="none")
    base = flat_lib._flat_ops(cfg, flat_spec, grad_fn, lr_fn, None,
                              optimizer, torch.device(device))

    def round_fn(state: FlatFedState, batches, draws, mix: CohortMix):
        ops = dataclasses.replace(
            base,
            sample_w=lambda draws, t: mix,
            gossip=cohort_gossip,
            server=_hierarchical_server(mix, h, k, server_enabled)
            if spec.n_clusters > 1 else base.server)
        step = engine.build_step_body(ops)
        return engine.make_loop_round(step, metrics_fn)(state, batches,
                                                        draws)

    return round_fn


# ---------------------------------------------------------------------------
# The streaming engine (double-buffered host↔device pipeline)
# ---------------------------------------------------------------------------


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


@dataclasses.dataclass
class _Cohort:
    """One scheduled round: its ids, its device buffer and tables, its
    batches, and the copy-stream event after which they are on the card
    (None on the CPU)."""

    ids: np.ndarray
    flat: torch.Tensor
    mix: CohortMix
    ready: Any = None
    batches: Any = None


class PopulationEngine:
    """Cohort-streamed FedDec over a host-resident population.

    Round r runs (``overlap=True``, the default):

      launch round r on the compute stream
      write back round r−1     (its rows come back on the copy stream as
                                soon as r−1 is done; the host waits for r−1
                                only)
      sample cohort r+1; if it meets cohort r, drain (wait for r, write it
                                back), so no round reads a row in flight
      gather round r+1 into pinned memory, build its tables, upload both
                                on the copy stream (the compute stream
                                waits for them before round r+1)

    ``overlap=False`` waits for the device after every round: the
    synchronous schedule.  Both make the same host calls in the same
    order, so their trajectories are equal bit for bit.  How much the
    host stages hide under round r is bounded by how far the host's
    dispatch runs ahead of the device.

    Runs on ``device`` ('cuda' unless the caller passes 'cpu', as the
    tests do).  On the CPU there is nothing to overlap and the rows move
    by plain copies.  On the card the engine pins three (cohort, D)
    staging buffers when it is made (two for uploads, one for
    write-backs); failing to pin fails it.
    """

    def __init__(self, spec: PopulationSpec, flat_spec: FlatSpec,
                 grad_fn: engine.GradFn, lr_fn: LrFn,
                 graph: "topo.SparseGraph | topo.Graph", *, h: int, k: int,
                 device="cuda", server_enabled: bool = True,
                 optimizer=None, store: PopulationStore | None = None,
                 row_init=None, store_path: str | None = None,
                 delta: str = "none", weights: np.ndarray | None = None,
                 metrics_fn=None):
        n = graph.n
        if n != spec.n_total:
            raise ValueError(
                f"graph has n={n} nodes but spec.n_total={spec.n_total}")
        if optimizer is not None:
            raise NotImplementedError(
                "population mode streams bare parameter rows (Algorithm 1's "
                "stateless SGD); per-agent optimizer state is not streamed")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the population "
                               "engine runs on the GPU unless asked for the "
                               "CPU (device='cpu')")
        self.spec = spec
        self.flat_spec = flat_spec
        self.graph = graph if isinstance(graph, topo.SparseGraph) \
            else topo.csr_from_graph(graph)
        self.h, self.k = h, k
        self.weights = weights
        self._np_dtype = _numpy_dtype(flat_spec.dtype)
        if isinstance(row_init, torch.Tensor):
            row_init = row_init.detach().cpu().numpy()
        if store is None:
            if row_init is None:
                raise ValueError("pass either store= or row_init=")
            row = np.asarray(row_init, dtype=self._np_dtype)
            if delta != "none":
                # base = z^1 and every agent row an encoded (zero) delta:
                # the host store is O(n_total·K), not O(n_total·D)
                from repro_torch.core.delta import DeltaStore
                store = DeltaStore.create(spec.n_total, row, delta,
                                          path=store_path,
                                          dtype=self._np_dtype)
            else:
                store = PopulationStore.create(spec.n_total, row,
                                               path=store_path,
                                               dtype=self._np_dtype)
        elif delta != "none":
            from repro_torch.core.delta import DeltaStore
            if not isinstance(store, DeltaStore):
                raise ValueError("delta != 'none' with an explicit store= "
                                 "needs a DeltaStore")
        if store.d != flat_spec.d:
            raise ValueError(f"store D={store.d} != flat spec D="
                             f"{flat_spec.d}")
        self.store = store
        self.round_idx = 0
        self.step = 1                     # the paper's t (starts at 1)
        self._rng = np.random.default_rng(spec.seed)
        self._round = make_cohort_round(
            spec, flat_spec, grad_fn, lr_fn, h=h, k=k, device=self.device,
            server_enabled=server_enabled, optimizer=optimizer,
            metrics_fn=metrics_fn)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # the copy stream, two pinned upload slots and one pinned
            # write-back buffer, taken once (pinning gigabytes takes
            # seconds)
            shape = (spec.cohort_size, flat_spec.d)
            self._copy = torch.cuda.Stream(self.device)
            self._up = [torch.empty(shape, dtype=flat_spec.dtype,
                                    pin_memory=True) for _ in range(2)]
            self._down = torch.empty(shape, dtype=flat_spec.dtype,
                                     pin_memory=True)
        self._up_done: list = [None, None]
        self._slot = 0
        #: per-stage times of the last run: host seconds spent dispatching
        #: the rounds, waiting for them, preparing the next (gathering
        #: included) and scattering; device ms of the uploads and
        #: write-backs (copy stream, CUDA events)
        self.stats: dict = {}
        self._events: list = []

    # -- pipeline stages ----------------------------------------------------

    def _sample(self) -> np.ndarray:
        """Cohort ids for round ``self.round_idx`` (the next unscheduled)."""
        return sample_cohort(self._rng, self.spec, self.store.last_round,
                             self.round_idx, self.weights)

    def _gather(self, ids: np.ndarray, out: np.ndarray) -> None:
        t0 = time.perf_counter()
        if isinstance(self.store, PopulationStore):
            self.store.gather(ids, out=out)
        else:                             # a DeltaStore decodes its rows
            out[...] = self.store.gather(ids)
        self.stats["gather_s"].append(time.perf_counter() - t0)

    def _timed(self, kind: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        self._events.append((kind, start, end))
        return start, end

    def _prepare(self, ids: np.ndarray, batch_fn, round_idx: int) -> _Cohort:
        """Host stage: tables, gather, upload (async on the card), and the
        round's batches."""
        t0 = time.perf_counter()
        cohort = self._stage(ids, round_idx)
        cohort.batches = batch_fn(round_idx, ids)
        self.stats["prepare_s"].append(time.perf_counter() - t0)
        return cohort

    def _stage(self, ids: np.ndarray, round_idx: int) -> _Cohort:
        """The cohort's tables and rows, on the card through a pinned slot
        and the copy stream."""
        ages = self.store.ages(ids, round_idx)
        tables = _cohort_tables(self.graph, ids, self.spec, ages,
                                self._np_dtype)
        # participation is marked at schedule time, so that the 'stale'
        # sampler and the age tilt see the cohorts in flight
        if not self._cuda:
            rows = np.empty((len(ids), self.store.d), self._np_dtype)
            self._gather(ids, rows)
            self.store.last_round[ids] = round_idx
            return _Cohort(ids, torch.from_numpy(rows),
                           _to_mix(tables, self.device))
        slot = self._slot
        self._slot ^= 1
        if self._up_done[slot] is not None:
            self._up_done[slot].synchronize()   # its last upload has left
        host = self._up[slot]
        self._gather(ids, host.numpy())
        self.store.last_round[ids] = round_idx
        with torch.cuda.stream(self._copy):
            mix = _to_mix(tables, self.device, non_blocking=True)
            start, end = self._timed("h2d_ms")
            start.record(self._copy)
            flat = host.to(self.device, non_blocking=True)
            end.record(self._copy)
        self._up_done[slot] = end
        return _Cohort(ids, flat, mix, ready=end)

    def _launch(self, cohort: _Cohort, draws):
        """Dispatch one round on the compute stream; returns (state,
        metrics, the compute-stream event that ends it)."""
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(cohort.ready)
            # made on the copy stream, read on the compute stream: their
            # memory must not return to the copy stream's pool before the
            # round is done with it
            for t in (cohort.flat,) + cohort.mix.tensors():
                t.record_stream(compute)
        # the round owns the uploaded rows from here (the flat engine frees
        # them after its first step)
        state = FlatFedState(flat=cohort.flat, step=self.step)
        cohort.flat = None
        t0 = time.perf_counter()
        new_state, metrics = self._round(state, cohort.batches, draws,
                                         cohort.mix)
        self.stats["launch_s"].append(time.perf_counter() - t0)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return new_state, metrics, done

    def _writeback(self, ids: np.ndarray, state: FlatFedState, metrics,
                   done, out: list) -> None:
        """Host stage: the round's rows and metrics back to the host; waits
        for this round only."""
        if self._cuda:
            with torch.cuda.stream(self._copy):
                self._copy.wait_event(done)
                start, end = self._timed("d2h_ms")
                start.record(self._copy)
                self._down.copy_(state.flat, non_blocking=True)
                metrics = {key: v.to("cpu", non_blocking=True)
                           for key, v in metrics.items()}
                end.record(self._copy)
            t0 = time.perf_counter()
            end.synchronize()
            self.stats["wait_s"].append(time.perf_counter() - t0)
            rows = self._down.numpy()
        else:
            rows = state.flat.numpy()
        t0 = time.perf_counter()
        self.store.scatter(ids, rows)
        self.stats["scatter_s"].append(time.perf_counter() - t0)
        out.append({key: v.numpy() for key, v in metrics.items()})

    # -- the round loop -----------------------------------------------------

    def run(self, n_rounds: int, batch_fn, draws, *,
            overlap: bool = True) -> dict:
        """Run ``n_rounds`` H-step rounds over the population.

        Args:
          n_rounds: rounds to run.
          batch_fn: ``(round_idx, ids) -> batches``, every leaf (H, c,
            ...) on the engine's device: the cohort's data, made in the
            host stage of the round before.
          draws: the engine's random draws (core/draws.Draws; the server's
            K participants keyed by the step counter t, which starts at 1
            and advances by H a round).
          overlap: the double-buffered schedule (False: wait for the device
            after every round).

        Returns:
          the per-round metrics stacked (numpy, leading dim n_rounds) and
          ``'drains'``: how often the conflict check serialized a round.
        """
        self.stats = {"launch_s": [], "wait_s": [], "prepare_s": [],
                      "gather_s": [], "scatter_s": [], "h2d_ms": [],
                      "d2h_ms": []}
        self._events = []
        if n_rounds < 1:
            return {"drains": 0}
        out: list = []
        drains = 0
        nxt = self._prepare(self._sample(), batch_fn, self.round_idx)
        pending = None
        for r in range(n_rounds):
            ids = nxt.ids
            launched = (ids, *self._launch(nxt, draws))
            del nxt
            if not overlap and self._cuda:
                t0 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                self.stats["wait_s"].append(time.perf_counter() - t0)
            if pending is not None:
                self._writeback(*pending, out)   # round r−1
            pending = launched
            del launched
            self.step += self.h
            self.round_idx += 1
            if r + 1 < n_rounds:
                nxt_ids = self._sample()
                if np.intersect1d(nxt_ids, ids, assume_unique=True).size:
                    # the next cohort reads rows still in flight: drain
                    self._writeback(*pending, out)
                    pending = None
                    drains += 1
                nxt = self._prepare(nxt_ids, batch_fn, self.round_idx)
        if pending is not None:
            self._writeback(*pending, out)
        for kind, start, end in self._events:
            self.stats[kind].append(start.elapsed_time(end))
        self._events = []
        stacked = {key: np.stack([m[key] for m in out]) for key in out[0]}
        stacked["drains"] = drains
        return stacked
