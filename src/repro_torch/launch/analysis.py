"""Analytic cost models of the port (repro/launch/analysis.py, in part).

Plain arithmetic on shapes, equal to the reference's function for
function (each docstring names the collectives in the reference's terms:
its ``psum_scatter``, ``ppermute`` halo and ``psum`` are the port's
``reduce_scatter_tensor``, ``batch_isend_irecv`` halo and
``all_reduce``, core/sharded.py): the gossip, sharded-gossip, 2-D mesh, sweep, sharded-sweep,
population, delta, fused-round and compressed-halo models, the payload
byte counts, and the roofline terms.  ``pred_us`` and the roofline's
seconds are the reference's, at its constants below.

The reference's parsing of XLA's optimized HLO text
(``parse_collectives``, ``CollectiveStats``, ``_shape_bytes``) has no
counterpart here yet: the port has no HLO (ROADMAP Queue A item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["PEAK_FLOPS", "HBM_BW", "ICI_BW", "H2D_BW", "roofline_terms",
           "RooflineReport", "dtype_bytes", "gossip_cost_model",
           "sharded_gossip_cost_model", "mesh2d_cost_model",
           "sweep_cost_model", "sharded_sweep_cost_model",
           "population_cost_model", "compress_row_bytes",
           "compressed_halo_cost_model", "COMPRESS_SCHEMES",
           "delta_row_bytes", "delta_cost_model", "roundfuse_cost_model"]

# The reference's roofline constants for its own accelerator
# (repro/launch/analysis.py:34-37), kept so that every model's pred_us and
# the roofline terms equal the reference's.  They describe no part of the
# H100 and its host, and the port predicts no card time from them:
# chip_smoke.py measures the card's times and rates, and its bounds take
# the H100's own memory rate.
PEAK_FLOPS = 197e12
HBM_BW = 819e9
ICI_BW = 50e9
H2D_BW = 16e9

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def dtype_bytes(name: str) -> int:
    """Bytes of an XLA element type name (4 for a name it does not know)."""
    return _DTYPE_BYTES.get(name, 4)


@dataclasses.dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float            # total across devices (cost_analysis × chips)
    hlo_bytes: float
    collective_bytes: float     # per-device sum over ops
    model_flops: float          # analytic 6·N·D (or 2·N·D decode)
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> dict[str, Any]:
        return {
            "name": self.name, "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_flops_ratio,
        }


def gossip_cost_model(*, n_agents: int, d: int, num_leaves: int,
                      num_directed_edges: int, param_bytes: int = 4,
                      dispatch_us: float = 5.0) -> dict[str, dict]:
    """Analytic per-gossip-step cost of every impl × state layout.

    The gossip contraction Y = W X (X the stacked (n, D) parameters) is
    bandwidth-bound for small n (2n FLOP per ``param_bytes`` streamed is far
    below the ridge point) and compute-bound once n² FLOPs dominate — which
    is exactly the regime split the flat engine's impls target:

      * ``tree_dense``  — leaf-wise einsum: streams X once per leaf AND
        materialises an f32 upcast of each non-f32 leaf (2× read tax),
        plus one dispatch per leaf inside the scan body;
      * ``flat_dense``  — one whole-buffer einsum: same upcast tax, one
        dispatch, no per-leaf padding;
      * ``flat_pallas`` — one kernel call: X streams through VMEM exactly
        once with the cast fused (no upcast materialisation), W resident;
      * ``flat_sparse`` — gather + segment_sum over the CSR edge list:
        reads |E| rows instead of computing n² dot products — the FLOP
        term drops from 2n²D to 2|E|D, which is what survives n ≳ 256.

    Returns {impl: {bytes, flops, dispatches, pred_us}} with pred_us =
    max(memory, compute) + dispatch overhead at the module constants
    (HBM_BW, PEAK_FLOPS; dispatch_us per dispatch — host-side, so it
    vanishes inside a fused scan but bounds the per-step executor).
    """
    n, dd, b = n_agents, float(d), param_bytes
    stream = 2.0 * n * dd * b                 # read X + write Y once
    upcast = 2.0 * n * dd * 4 if b != 4 else 0.0  # f32 temp write+read
    dense_flops = 2.0 * n * n * dd
    sparse_flops = 2.0 * num_directed_edges * dd
    sparse_bytes = (num_directed_edges + 2.0 * n) * dd * b  # gather+own+Y

    def entry(bytes_, flops, dispatches):
        pred = max(bytes_ / HBM_BW, flops / PEAK_FLOPS) * 1e6 \
            + dispatches * dispatch_us
        return {"bytes": bytes_, "flops": flops, "dispatches": dispatches,
                "pred_us": pred}

    return {
        "tree_dense": entry(stream + upcast, dense_flops, num_leaves),
        "flat_dense": entry(stream + upcast, dense_flops, 1),
        "flat_pallas": entry(stream, dense_flops, 1),
        "flat_sparse": entry(sparse_bytes, sparse_flops, 1),
    }


def sharded_gossip_cost_model(*, n_agents: int, d: int, n_shards: int,
                              num_cut_edges: int, num_halo_rounds: int,
                              param_bytes: int = 4,
                              dispatch_us: float = 5.0) -> dict[str, dict]:
    """Analytic per-gossip-step cost of the agent-sharded flat engine.

    The agent dim of the (n, D) buffer is block-sharded over ``n_shards``
    devices (n_local = n/n_shards rows each; repro.core.sharded).  Per-shard
    HBM traffic and FLOPs shrink by n_shards, and the collective term splits
    the impls:

      * ``dense``  — W[:, cols] @ x_blk partials + one ring psum_scatter:
        each device moves ~((s−1)/s)·n·D bytes regardless of the graph;
      * ``sparse`` — the ppermute halo: ``num_halo_rounds`` block exchanges
        of n_local·D bytes per device, i.e. traffic scales with the
        *quotient* degree (the graph's cut), not with n.  For a ring over
        contiguous blocks this is 2 rounds total at any scale — the
        weak-scaling regime bench_sharded.py measures.

    ``ideal_cut_edge_bytes`` is the graph-theoretic floor (one row of D per
    directed cut edge, summed over devices): the halo moves whole blocks, so
    ``collective_bytes × n_shards ≥ ideal`` with equality when every
    neighbouring block pair is fully cut-connected.

    Returns {impl: {per_device_bytes, flops, collective_bytes, pred_us}}
    (collective_bytes per device; pred at TPU constants, CPU CI only checks
    the relative shape).
    """
    n, dd, b, s = n_agents, float(d), param_bytes, n_shards
    n_local = n // s
    stream_blk = 2.0 * n_local * dd * b            # read + write own block

    def entry(bytes_, flops, coll_bytes, extra=None):
        pred = max(bytes_ / HBM_BW, flops / PEAK_FLOPS) * 1e6 \
            + coll_bytes / ICI_BW * 1e6 + dispatch_us
        out = {"per_device_bytes": bytes_, "flops": flops,
               "collective_bytes": coll_bytes, "pred_us": pred}
        if extra:
            out.update(extra)
        return out

    # dense: write the (n, D) partial, read it back for the reduce-scatter
    dense_bytes = stream_blk + 2.0 * n * dd * b
    dense_flops = 2.0 * n * n_local * dd
    dense_coll = (s - 1) / s * n * dd * b if s > 1 else 0.0

    # sparse halo: own-block contraction + one sub-block contraction and one
    # block receive per round
    halo_bytes = stream_blk + num_halo_rounds * n_local * dd * b
    halo_flops = 2.0 * (1 + num_halo_rounds) * n_local * n_local * dd
    halo_coll = num_halo_rounds * n_local * dd * b if s > 1 else 0.0
    ideal_cut = num_cut_edges * dd * b

    return {
        "dense": entry(dense_bytes, dense_flops, dense_coll),
        "sparse": entry(halo_bytes, halo_flops, halo_coll,
                        {"num_halo_rounds": num_halo_rounds,
                         "ideal_cut_edge_bytes": ideal_cut}),
        "pallas": entry(halo_bytes, halo_flops, halo_coll,
                        {"num_halo_rounds": num_halo_rounds}),
        "none": entry(stream_blk, 0.0, 0.0),
    }


def mesh2d_cost_model(*, n_agents: int, d: int, n_agent_shards: int,
                      n_model_shards: int, num_halo_rounds: int = 0,
                      param_bytes: int = 4,
                      dispatch_us: float = 5.0) -> dict[str, dict]:
    """Analytic per-step cost of the 2-D ('agents', 'model') engine.

    The flat (n, D) buffer lives on an A×M mesh (``make_fed_mesh``): each
    device owns n/A agent rows × D/M columns, so

      * ``state_bytes_per_device = n/A · D/M · param_bytes`` — exact, the
        A·M-way memory scaling the 2-D mesh buys;
      * agent-axis gossip bytes are the 1-D engine's formulas evaluated on
        the D/M column slice each device owns — dense psum_scatter moves
        ``(A−1)/A · n · D/M · b``, the ppermute halo
        ``rounds · n/A · D/M · b`` (collectives over 'agents' only);
      * ``model_collective_bytes = 2·(M−1)/M · n/A · b`` — the one
        unavoidable model-axis collective per step: the per-agent losses
        are reductions over the column-sharded D axis, so their (n_local,)
        vector all-reduces over 'model' (ring all-reduce ≈ 2·(M−1)/M of
        the payload).  Model-parallel matmul collectives inside grad_fn
        are arch-specific and excluded — this column prices the *engine's*
        floor;
      * ``server_bytes_per_round = 2·(A−1)/A · D/M · b`` — the (D,) server
        psum over 'agents' also operates on the D/M slice, every H steps.

    Returns {impl: {state_bytes_per_device, gossip_collective_bytes,
    model_collective_bytes, server_bytes_per_round, pred_us}} with the
    same TPU-constant roofline as :func:`sharded_gossip_cost_model`.
    """
    n, dd, b = n_agents, float(d), param_bytes
    a, m = n_agent_shards, n_model_shards
    n_local = n // a
    d_local = dd / m
    state = n_local * d_local * b
    model_coll = 2.0 * (m - 1) / m * n_local * b if m > 1 else 0.0
    server = 2.0 * (a - 1) / a * d_local * b if a > 1 else 0.0

    def entry(gossip_coll):
        coll = gossip_coll + model_coll
        pred = 2.0 * state / HBM_BW * 1e6 + coll / ICI_BW * 1e6 \
            + dispatch_us
        return {"state_bytes_per_device": state,
                "gossip_collective_bytes": gossip_coll,
                "model_collective_bytes": model_coll,
                "server_bytes_per_round": server,
                "pred_us": pred}

    dense_coll = (a - 1) / a * n * d_local * b if a > 1 else 0.0
    halo_coll = num_halo_rounds * n_local * d_local * b if a > 1 else 0.0
    return {
        "dense": entry(dense_coll),
        "sparse": entry(halo_coll),
        "pallas": entry(halo_coll),
        "none": entry(0.0),
    }


def sweep_cost_model(*, r_runs: int, n_agents: int, d: int,
                     t_steps: int | None = None, h: int | None = None,
                     param_bytes: int = 4, opt_slots: int = 0,
                     residual: bool = False,
                     dispatch_us: float = 5.0) -> dict:
    """Analytic cost of the batched sweep engine vs the per-run loop.

    The sweep engine (repro.core.sweep) stacks R runs into one
    ``(R, n_agents, D)`` buffer and scans all of them in one compiled
    program; the per-run baseline (the pre-sweep figure-driver / train-loop
    pattern) dispatches one fused H-step engine call **per run per server
    window** — R·(T/H) dispatch + host-sync round-trips per trajectory.
    Per-step device *work* is identical (R × the single-run bytes/FLOPs —
    ``gossip_cost_model`` per impl, R×); what the batch removes is the
    fixed per-dispatch cost, which dominates when the per-run tensors are
    tiny (the figure regime: n=20, D=25).

    Returns the exact columns the regression guard pins:
      * ``state_bytes``       — R·n·D·b·(1 + opt_slots + residual), the
        resident sweep state (the dryrun memory prediction);
      * ``step_stream_bytes`` — 2·R·n·D·b, one read+write pass over the
        lattice buffer per step (the local-update floor; gossip adds its
        impl term from ``gossip_cost_model`` × R);
      * ``dispatches_loop``   — R·(T/H) (one engine call per run per
        window; R when T/H is unknown) vs ``dispatches_sweep`` = 1;
      * ``dispatch_overhead_us_saved`` — (dispatches_loop − 1)·dispatch_us
        (vanishes into the single program).
    """
    slots = 1 + opt_slots + (1 if residual else 0)
    state_bytes = float(r_runs * n_agents * d * param_bytes * slots)
    step_stream = 2.0 * r_runs * n_agents * d * param_bytes
    n_windows = max(1, t_steps // h) if t_steps and h else 1
    disp_loop = r_runs * n_windows
    out = {
        "r_runs": r_runs,
        "state_bytes": state_bytes,
        "step_stream_bytes": step_stream,
        "dispatches_loop": disp_loop,
        "dispatches_sweep": 1,
        "dispatch_overhead_us_saved": (disp_loop - 1) * dispatch_us,
    }
    if t_steps is not None:
        out["t_steps"] = int(t_steps)
    return out


def sharded_sweep_cost_model(*, r_runs: int, n_agents: int, d: int,
                             n_shards: int, num_halo_rounds: int,
                             t_steps: int | None = None, h: int | None = None,
                             param_bytes: int = 4, opt_slots: int = 0,
                             residual: bool = False,
                             dispatch_us: float = 5.0) -> dict:
    """Analytic cost of the composed sharded-sweep engine (R runs × s shards).

    The composition (repro.core.engine.make_sharded_sweep_round) lowers the
    whole (R, n_agents, D) lattice with the agent dim block-sharded over
    ``n_shards`` devices: each device carries an (R, n_local, D) block and
    the entire T-step scan runs inside one shard_map — one program for the
    full figure lattice.  Relative to the unsharded sweep engine
    (``sweep_cost_model``) every per-device term shrinks by n_shards and a
    collective term appears, which splits by gossip impl exactly as in
    ``sharded_gossip_cost_model`` but with every payload R× wider (the run
    axis rides along in each psum_scatter / ppermute block):

      * ``state_bytes_per_device``        — R·n_local·D·b·slots, the
        resident lattice block (slots = 1 + opt_slots + residual);
      * ``step_stream_bytes_per_device``  — 2·R·n_local·D·b, one
        read+write pass over the block per step (the local-update floor);
      * ``dense_collective_bytes``        — (s−1)/s·R·n·D·b per device per
        gossip step (the ring psum_scatter over the R-wide partials);
      * ``halo_collective_bytes``         — rounds·R·n_local·D·b per device
        per gossip step (the union-quotient ppermute schedule: the halo
        count comes from the OR of the R run graphs, so it is the max over
        runs, not the sum);
      * ``dispatches_loop``               — R·(T/H) engine calls for the
        per-run loop vs ``dispatches_sweep`` = 1 (the whole lattice is one
        dispatch even sharded).
    """
    n, dd, b, s = n_agents, float(d), param_bytes, n_shards
    if n % s:
        raise ValueError(f"n_agents={n} must be divisible by "
                         f"n_shards={s}")
    n_local = n // s
    slots = 1 + opt_slots + (1 if residual else 0)
    state_blk = float(r_runs * n_local * dd * b * slots)
    step_stream = 2.0 * r_runs * n_local * dd * b
    dense_coll = (s - 1) / s * r_runs * n * dd * b if s > 1 else 0.0
    halo_coll = num_halo_rounds * r_runs * n_local * dd * b if s > 1 else 0.0
    n_windows = max(1, t_steps // h) if t_steps and h else 1
    disp_loop = r_runs * n_windows
    out = {
        "r_runs": r_runs,
        "n_shards": s,
        "n_local": n_local,
        "state_bytes_per_device": state_blk,
        "step_stream_bytes_per_device": step_stream,
        "dense_collective_bytes": dense_coll,
        "halo_collective_bytes": halo_coll,
        "num_halo_rounds": int(num_halo_rounds),
        "dispatches_loop": disp_loop,
        "dispatches_sweep": 1,
        "dispatch_overhead_us_saved": (disp_loop - 1) * dispatch_us,
    }
    if t_steps is not None:
        out["t_steps"] = int(t_steps)
    return out


def population_cost_model(*, n_total: int, cohort_size: int, d: int,
                          max_degree: int, h: int, param_bytes: int = 4,
                          idx_bytes: int = 4, counter_bytes: int = 8,
                          h2d_bw: float = H2D_BW) -> dict:
    """Bytes-a-round model of the population engine
    (repro/launch/analysis.py:412-455).

    The (n_total, D) store is on the host and one cohort is streamed a
    round, so every device-side term depends on the cohort only:

      * ``host_store_bytes``: n_total·(D·b + counter_bytes), the memmap
        rows and each agent's last-participation counter (host only);
      * ``upload_bytes_round`` / ``writeback_bytes_round``: cohort·D·b
        each, ``hostdev_bytes_round`` their sum;
      * ``subgraph_edge_bytes_round``: the cohort's ELL tables,
        cohort·max_degree·(idx + param bytes) + cohort·(diag + cluster);
      * ``peak_device_bytes``: two cohort buffers in flight and two sets
        of tables, 2·(cohort·D·b) + 2·edge tables, with no n_total term;
      * ``transfer_us_round``: hostdev_bytes_round / h2d_bw, the
        synchronous transfer time that the overlap can hide.
    """
    row_bytes = float(cohort_size * d * param_bytes)
    edge_bytes = float(cohort_size * max_degree * (idx_bytes + param_bytes)
                       + cohort_size * (param_bytes + idx_bytes))
    hostdev = 2.0 * row_bytes
    return {
        "n_total": int(n_total),
        "cohort_size": int(cohort_size),
        "d": int(d),
        "max_degree": int(max_degree),
        "steps_per_round": int(h),
        "host_store_bytes": float(n_total * (d * param_bytes
                                             + counter_bytes)),
        "upload_bytes_round": row_bytes,
        "writeback_bytes_round": row_bytes,
        "hostdev_bytes_round": hostdev,
        "subgraph_edge_bytes_round": edge_bytes,
        "peak_device_bytes": 2.0 * row_bytes + 2.0 * edge_bytes,
        "transfer_us_round": hostdev / h2d_bw * 1e6,
    }


def delta_row_bytes(delta: str, d: int, param_bytes: int = 4) -> float:
    """Analytic per-agent payload bytes of a delta parameterization.

    Mirrors ``repro.core.delta.delta_store_bytes_per_row`` without
    importing the codecs: 'full' stores the
    two-term exact delta (2·D·b — the bit-identity anchor, not a
    compression), 'topk:K' keeps K (value, int32 index) pairs, 'lowrank:R'
    keeps the rank-R factors of the near-square (d1, d2) reshape.
    """
    if delta == "none":
        return float(d * param_bytes)
    if delta == "full":
        return float(2 * d * param_bytes)
    if delta.startswith("topk:"):
        k = min(int(delta[5:]), d)
        return float(k) * (param_bytes + 4.0)
    if delta.startswith("lowrank:"):
        d1, f = 1, 1
        while f * f <= d:          # largest divisor of d below sqrt(d)
            if d % f == 0:
                d1 = f
            f += 1
        d2 = d // d1
        r = min(int(delta[8:]), d1)
        return float(r * (d1 + d2) * param_bytes)
    raise ValueError(f"unknown delta scheme {delta!r}")


def delta_cost_model(*, n_total: int, d: int, delta: str,
                     param_bytes: int = 4, counter_bytes: int = 8) -> dict:
    """Analytic host-store byte model of the delta parameterization.

    The delta store (repro.core.delta.DeltaStore) replaces the population
    engine's dense (n_total, D) memmap with one shared base row plus
    per-agent encoded payloads, so the host store shrinks from
    O(n_total·D) to O(n_total·K).  Returns the exact columns the
    regression guard recomputes:

      * ``delta_row_bytes``   — encoded payload bytes per agent (also the
        gossip wire bytes of the delta-encoded exchange);
      * ``flat_store_bytes``  — the dense baseline,
        n_total·(D·b + counter_bytes) (== population_cost_model's
        ``host_store_bytes``);
      * ``delta_store_bytes`` — D·b (base) + n_total·(row + counter);
      * ``store_ratio``       — delta / flat, the ≤ 0.25× acceptance
        column at n_total = 1e6 for topk stores.
    """
    row = delta_row_bytes(delta, d, param_bytes)
    flat_store = float(n_total * (d * param_bytes + counter_bytes))
    delta_store = float(d * param_bytes
                        + n_total * (row + counter_bytes))
    return {
        "n_total": int(n_total),
        "d": int(d),
        "delta": delta,
        "delta_row_bytes": row,
        "flat_row_bytes": float(d * param_bytes),
        "flat_store_bytes": flat_store,
        "delta_store_bytes": delta_store,
        "store_ratio": delta_store / flat_store,
    }


def roundfuse_cost_model(*, n_agents: int, d: int, optimizer: str = "sgd",
                         codec: bool = False, r_runs: int = 1,
                         param_bytes: int = 4, n_shards: int = 1,
                         boundary_rows_per_shard: int = 0,
                         num_halo_rounds: int = 0) -> dict:
    """Exact full-buffer-pass byte model of the fused FedDec round.

    Counts whole (R·n·D·b)-sized streams through HBM per step — the unit
    the fused update+mix kernels (kernels/update_mix.py) eliminate.  The
    convention: one "pass" = one read or write of a full (r_runs, n, D)
    buffer; the (n, n) W / ELL tables and sub-D-row payloads (int8 scales,
    η) are excluded as lower-order, so the model is conservative for the
    fused path (which also skips W re-reads between the two ops).

    Pass counts per step:

      * update (line 5): sgd reads x, g and writes p → 3;
        momentum also reads + writes the f32 slot → 5;
      * unfused mix (line 6): reads p, writes y → +2;
      * fused update+mix: p forms in VMEM, y written directly → +0;
      * codec active (EF gossip): both paths share u = p + e (3),
        encode (1), decode (1); the unfused tail is mix (2) + diag
        correction (4: mix-out, p, s → y) + residual (3: u, s → res)
        = +14 total, the fused ef-kernel tail reads p, s, u and writes
        y, res = +10 total (the update itself stays on XLA — the int8
        row scale is a full-row reduction no D tile can compute).

    Sharded overlap terms (``n_shards > 1``): each shard's rows split into
    boundary (on a directed cut edge of the quotient graph — the only rows
    whose columns are live in another shard's W block) vs interior; the
    halo then moves ``boundary_rows_per_shard`` rows instead of the whole
    n_local block, and interior compute hides the in-flight rounds.
    ``predicted_overlap_fraction`` = min(1, interior stream time / halo
    time) at the module roofline constants.

    Returns the exact columns the reference's regression guard
    recomputes.
    """
    if optimizer not in ("sgd", "momentum"):
        raise ValueError(f"roundfuse_cost_model covers sgd|momentum "
                         f"(adamw stays unfused): {optimizer!r}")
    upd = 3 if optimizer == "sgd" else 5
    if codec:
        passes_unfused, passes_fused = upd + 14, upd + 10
    else:
        passes_unfused, passes_fused = upd + 2, upd
    buf = float(r_runs) * n_agents * d * param_bytes
    out = {
        "n_agents": int(n_agents),
        "d": int(d),
        "r_runs": int(r_runs),
        "optimizer": optimizer,
        "codec": bool(codec),
        "param_bytes": int(param_bytes),
        "passes_unfused": passes_unfused,
        "passes_fused": passes_fused,
        "unfused_pass_bytes": passes_unfused * buf,
        "fused_pass_bytes": passes_fused * buf,
        "pass_ratio": passes_fused / passes_unfused,
    }
    if n_shards > 1:
        if n_agents % n_shards:
            raise ValueError(f"n_agents={n_agents} must be divisible by "
                             f"n_shards={n_shards}")
        n_local = n_agents // n_shards
        b_rows = min(int(boundary_rows_per_shard), n_local)
        i_rows = n_local - b_rows
        halo_full = num_halo_rounds * n_local * float(d) * param_bytes
        halo_boundary = num_halo_rounds * b_rows * float(d) * param_bytes
        interior_s = (passes_fused * r_runs * i_rows * float(d)
                      * param_bytes) / HBM_BW
        halo_s = halo_boundary * r_runs / ICI_BW
        out.update({
            "n_shards": int(n_shards),
            "n_local": n_local,
            "boundary_rows_per_shard": b_rows,
            "interior_rows_per_shard": i_rows,
            "num_halo_rounds": int(num_halo_rounds),
            "halo_bytes_full": halo_full,
            "halo_bytes_boundary": halo_boundary,
            "halo_payload_ratio": (halo_boundary / halo_full
                                   if halo_full else 1.0),
            "predicted_overlap_fraction": (min(1.0, interior_s / halo_s)
                                           if halo_s > 0 else 1.0),
        })
    return out


COMPRESS_SCHEMES = ("none", "bf16", "int8", "topk:0.1")


def compress_row_bytes(compress: str, d: int, param_bytes: int = 4) -> float:
    """Analytic wire bytes per agent row of the compressed gossip payload.

    Mirrors ``repro.core.compress.Compressor.wire_bytes_per_row`` without
    importing the codecs: int8 is one byte per element plus one f32 scale per row, top-k
    moves ⌈R·d⌉ (value, int32 index) pairs, bf16 halves the payload.
    """
    if compress in ("none", "identity"):
        return float(d * param_bytes)
    if compress == "bf16":
        return 2.0 * d
    if compress == "int8":
        return float(d) + 4.0
    if compress.startswith("topk:"):
        ratio = float(compress[5:])
        k = max(1, min(d, int(round(ratio * d))))
        return float(k) * (param_bytes + 4.0)
    raise ValueError(f"unknown compress scheme {compress!r}")


def compressed_halo_cost_model(*, n_agents: int, d: int, n_shards: int,
                               num_halo_rounds: int, param_bytes: int = 4,
                               schemes: tuple = COMPRESS_SCHEMES) -> dict:
    """Per-device halo collective bytes of the compressed sparse gossip.

    The sharded engine's halo (repro.core.sharded) moves one *encoded*
    (n_local, D) block per ppermute round, so per-device collective bytes
    are ``num_halo_rounds · n_local · compress_row_bytes(scheme)`` — the
    dense psum_scatter path is compression-oblivious (f32 partial sums) and
    is not modelled here.  ``payload_ratio_vs_f32`` is the column CI's
    regression guard pins (int8 ≈ 0.25 ≤ 0.30 at any realistic D).
    """
    n_local = n_agents // n_shards
    f32_row = float(d * param_bytes)
    out = {}
    for scheme in schemes:
        row = compress_row_bytes(scheme, d, param_bytes)
        coll = num_halo_rounds * n_local * row if n_shards > 1 else 0.0
        out[scheme] = {
            "row_payload_bytes": row,
            "collective_bytes": coll,
            "payload_ratio_vs_f32": row / f32_row,
            "pred_us": coll / ICI_BW * 1e6,
        }
    return out


def roofline_terms(*, name: str, chips: int, per_device_flops: float,
                   per_device_bytes: float, collective_bytes: float,
                   model_flops: float) -> RooflineReport:
    """Three roofline terms in seconds (per step).

    cost_analysis reports per-device numbers for SPMD modules; we scale
    FLOPs back to cluster totals for the useful-ratio but keep the time
    terms per-device (they are what bound the step).
    """
    return RooflineReport(
        name=name, chips=chips,
        hlo_flops=per_device_flops * chips,
        hlo_bytes=per_device_bytes * chips,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        compute_s=per_device_flops / PEAK_FLOPS,
        memory_s=per_device_bytes / HBM_BW,
        collective_s=collective_bytes / ICI_BW,
    )
