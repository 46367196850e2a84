"""Costs of a traced step: the port's counterpart of launch/hlo_analysis.py.

The reference re-derives loop-aware FLOPs, HBM traffic and collective
bytes from XLA's optimized HLO.  The port has no HLO: its lowered program
is the sequence of ops a step dispatches.  Two sources give one record,
:class:`OpCosts`, with the fields and methods of the reference's
``HloCosts`` (``profile(n)``, ``summary()``):

* :func:`tally` runs a step under a ``TorchDispatchMode``, on meta tensors
  (the dry run: shapes only, nothing allocated) or on real ones, and
  counts op by op:

  - FLOPs, from ``torch.utils.flop_counter``'s formulas, and for the
    kernel ops of kernels/ops.py (#1–#17) from their own work below;
  - bytes read and written: each op's tensor inputs plus its outputs.
    View and metadata ops and uninitialised allocations count zero (the
    reference's ``_CHEAP``); in eager mode every other op materializes,
    so the count is what an unfused run moves.  A kernel op reads its
    inputs and writes its outputs once, where the reference counts a
    Pallas custom call as free (hlo_analysis.py ``_CHEAP`` lists
    ``custom-call``): the port's kernels move real bytes, so they count;
  - collectives, from the ``c10d`` ops the step calls, named by the
    reference's kinds (all-reduce, reduce-scatter, all-gather,
    all-to-all, and collective-permute for the halo's sends and
    receives), with their output bytes, and each one's group as the
    global ranks it spans (a send or receive as its (source, target)
    pair of global ranks), the counterpart of HLO's ``replica_groups``
    and ``source_target_pairs``;
  - kernel launches by name (the ops of the ``repro_torch`` namespace; a
    call on meta tensors launches nothing, and the wrappers' launch
    counters do not move);
  - memory: the arguments' bytes, the largest sum of live storages along
    the step (weak references to each storage, so an activation that
    autograd keeps for the backward stays counted until it is freed),
    the outputs' bytes and those aliasing an argument.

  Python loops over layers, steps and microbatches dispatch their ops
  once per trip, so every count is loop-weighted by construction: there
  is no trip count to recover, as the reference must from a ``while``.

* :func:`analyze_trace` reads a Chrome trace that ``torch.profiler``
  exports on the card: device time and count by kernel name and by group
  (:func:`kernel_group`), the device's busy share and longest idle gaps,
  and the NCCL kernels, with bytes from the ``record_param_comms`` events
  where the trace has them.

* :func:`collective_axes` and :func:`axis_separation` classify those
  groups and pairs against the 2-D (A, M) mesh of launch/mesh.py
  (global rank a·M + m) by the reference's rules
  (repro/launch/hlo_analysis.py:356-446): a group whose ranks share
  r // M is on 'model', one whose ranks share r % M on 'agents', any
  other 'mixed'; a pair likewise.  One rank's tally sees the groups it
  belongs to, where the reference's HLO lists every group.
"""

from __future__ import annotations

import dataclasses
import json
import weakref
from pathlib import Path
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCosts", "TallyMode", "tally", "TraceCosts", "analyze_trace",
           "kernel_group", "device_events", "COLL_KINDS", "KERNEL_NAMESPACE",
           "CollectiveAxes", "collective_axes", "axis_separation"]

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

# the namespace of the kernel ops (kernels/ops.py)
KERNEL_NAMESPACE = "repro_torch"

# c10d's dispatcher ops -> the reference's collective kinds
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
# the point-to-point ops: (tensors, group, peer's rank in the group, tag)
_P2P = {"send": "send", "recv_": "recv"}

# ops that move no bytes: metadata, aliasing and uninitialised allocations
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
         "new_empty", "empty_strided", "new_empty_strided", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense", "_unsafe_view", "set_", "resize_"}


def _tensors(tree) -> list:
    """The tensors of a pytree, the engines' state dataclasses walked
    field by field."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out.extend(_tensors([getattr(leaf, f.name)
                                 for f in dataclasses.fields(leaf)]))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape(t) -> str:
    if isinstance(t, torch.Tensor):
        return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
    return type(t).__name__


# --- the kernel ops' FLOPs (their work, from the shapes) --------------------

def _mix_flops(x: torch.Tensor, deg: int) -> float:
    """An (R, n, D) or (n, D) mix reading ``deg`` rows a row: 2·deg·R·n·D."""
    return 2.0 * deg * x.numel()


def _kernel_flops(name: str, args: tuple, out) -> float:
    """The operations of one kernel call: the mix's multiply-adds (n a row
    for the dense kernels, max_deg + 1 for the ELL ones), plus the fused
    update's two a element; #15 four a (query, key) pair inside the
    causal window a head; #16 and #17 their recurrences' multiply-adds."""
    if name in ("gossip_mix", "gossip_mix_batched"):
        w, x = args[:2]
        return _mix_flops(x, w.shape[-1])
    if name in ("gossip_mix_sparse", "gossip_mix_sparse_batched"):
        nbr, x = args[0], args[3]
        return _mix_flops(x, nbr.shape[-1] + 1)
    if name in ("update_mix", "update_mix_batched"):
        w, x = args[:2]
        return _mix_flops(x, w.shape[-1]) + 2.0 * x.numel()
    if name in ("update_mix_sparse", "update_mix_sparse_batched"):
        nbr, x = args[0], args[3]
        return _mix_flops(x, nbr.shape[-1] + 1) + 2.0 * x.numel()
    if name in ("ef_mix", "ef_mix_batched"):
        w, p = args[:2]
        return _mix_flops(p, w.shape[-1]) + 3.0 * p.numel()
    if name in ("ef_mix_sparse", "ef_mix_sparse_batched"):
        nbr, p = args[0], args[3]
        return _mix_flops(p, nbr.shape[-1] + 1) + 3.0 * p.numel()
    if name in ("quant_mix", "dequant_mix"):
        w, p = args[0], args[-1] if name == "dequant_mix" else args[3]
        return _mix_flops(p, w.shape[-1]) + 4.0 * p.numel()
    if name == "flash_attention":
        q, _k, _v, window = args[:4]
        b, s, h, hd = q.shape
        keys = sum(min(i + 1, window) if window else i + 1
                   for i in range(s))
        return 4.0 * b * h * hd * keys
    if name == "ssd_scan":
        x, _dt, _a, bm = args[:4]
        return 4.0 * x.numel() * bm.shape[-1]
    if name == "rglru_scan":
        return 2.0 * args[0].numel()
    return 0.0


@dataclasses.dataclass
class OpCosts:
    """What one traced step costs (the fields of the reference's
    ``HloCosts``, plus the op counts, kernel launches and memory)."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLL_KINDS})
    collective_bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    # every collective's group: (kind, global ranks of its group, and for
    # a send or receive the (source, target) pair, else None); read by
    # collective_axes
    collective_groups: set = dataclasses.field(default_factory=set)
    # the heaviest ops, (bytes, op, shape, calls), summed over calls of
    # one op on one shape
    top_traffic: list = dataclasses.field(default_factory=list)
    top_collectives: list = dataclasses.field(default_factory=list)
    ops: int = 0
    op_counts: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        """The peak above the arguments: what the step itself allocates."""
        return self.peak_bytes - self.argument_bytes

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "alias_bytes": self.alias_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes}

    def profile(self, n: int = 12) -> str:
        """Human-readable hot-op report (the reference's dry-run profile)."""
        lines = [f"TOTAL flops={self.flops:.3e} "
                 f"traffic={self.traffic_bytes / 1e9:.1f}GB "
                 f"coll={self.collective_bytes / 1e9:.1f}GB ops={self.ops}",
                 "-- top traffic ops (bytes over all calls) --"]
        for b, kind, ty, calls in self.top_traffic[:n]:
            lines.append(f"  {b / 1e9:7.2f}GB  {kind:34s} {ty[:42]:42s} "
                         f"×{calls}")
        lines.append("-- top collectives --")
        for b, kind, ty, calls in self.top_collectives[:n]:
            lines.append(f"  {b / 1e9:7.2f}GB  {kind:34s} {ty[:42]:42s} "
                         f"×{calls}")
        return "\n".join(lines)

    def summary(self) -> str:
        cs = " ".join(
            f"{k}:{self.collective_counts[k]}x/"
            f"{self.collective_bytes_by_kind[k] / 1e6:.0f}MB"
            for k in COLL_KINDS if self.collective_counts[k])
        return (f"flops={self.flops:.3e} traffic={self.traffic_bytes:.3e}B "
                f"coll={self.collective_bytes:.3e}B [{cs or 'none'}] "
                f"ops={self.ops} peak={self.peak_bytes:.3e}B")


class TallyMode(TorchDispatchMode):
    """Counts every op dispatched under it into an :class:`OpCosts` (see
    the module docstring); ``track(tree)`` registers tensors that exist
    before the step, such as its arguments, as live storage."""

    def __init__(self):
        super().__init__()
        self.costs = OpCosts()
        self._live: dict[int, weakref.ref] = {}
        self._live_bytes = 0
        self._traffic: dict = {}
        self._colls: dict = {}

    # -- live storage -----------------------------------------------------
    def track(self, tree) -> int:
        """Register the storages of ``tree``'s tensors; their new bytes."""
        return sum(self._track(t) for t in _tensors(tree))

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        nbytes = st.nbytes()

        def gone(_ref, key=key, nbytes=nbytes, mode=weakref.ref(self)):
            m = mode()
            if m is not None and m._live.pop(key, None) is not None:
                m._live_bytes -= nbytes

        self._live[key] = weakref.ref(st, gone)
        self._live_bytes += nbytes
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)
        return nbytes

    @property
    def live_bytes(self) -> int:
        return self._live_bytes

    # -- the ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.costs
        packet = func._schema.name                # e.g. 'aten::mm'
        ns, _, base = packet.partition("::")
        c.ops += 1
        c.op_counts[packet] = c.op_counts.get(packet, 0) + 1
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if ns == "c10d" or ns == "_c10d_functional":
            kind = _C10D_KINDS.get(base)
            if kind is not None:
                b = sum(_nbytes(t) for t in _tensors(args[0] if args
                                                      else out))
                c.collective_counts[kind] += 1
                c.collective_bytes_by_kind[kind] += b
                c.collective_bytes += b
                key = (kind, _shape(args[0][0] if args and isinstance(
                    args[0], (list, tuple)) and args[0] else None))
                row = self._colls.setdefault(key, [0, 0])
                row[0] += b
                row[1] += 1
                c.collective_groups.add((kind,) + _group_of(base, args))
            return out
        if ns == KERNEL_NAMESPACE:
            c.launches[base] = c.launches.get(base, 0) + 1
            c.flops += _kernel_flops(base, args, out)
        elif func.overloadpacket in flop_registry:
            c.flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if ns == "prim" or func.is_view or base in _FREE:
            return out
        ins = _tensors((args, kwargs))
        b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.traffic_bytes += b
        key = (packet, _shape(outs[0] if outs else None))
        row = self._traffic.setdefault(key, [0, 0])
        row[0] += b
        row[1] += 1
        return out

    def finish(self) -> OpCosts:
        c = self.costs
        c.top_traffic = sorted(
            ((b, k, ty, n) for (k, ty), (b, n) in self._traffic.items()),
            key=lambda r: -r[0])[:64]
        c.top_collectives = sorted(
            ((b, k, ty, n) for (k, ty), (b, n) in self._colls.items()),
            key=lambda r: -r[0])[:64]
        return c


def _group_of(base: str, args) -> tuple:
    """(global ranks of the op's process group, (source, target) for a
    send or receive else None); ((), None) where the op names no group."""
    import torch.distributed as dist
    pg = None
    for i, a in enumerate(args):
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:      # a ReduceOp or an options object
                continue
            break
    if pg is None:
        return (), None
    ranks = tuple(dist.get_process_group_ranks(pg))
    pair = None
    if base in _P2P:
        peer = ranks[int(args[i + 1])]
        me = dist.get_rank()
        pair = (me, peer) if _P2P[base] == "send" else (peer, me)
    return ranks, pair


def tally(fn, *args, **kwargs) -> tuple[Any, OpCosts]:
    """Run ``fn(*args, **kwargs)`` under a :class:`TallyMode`; returns
    (its output, the :class:`OpCosts`).  The arguments' storages count as
    live from the start (``argument_bytes``); ``output_bytes`` and
    ``alias_bytes`` are read from the output's tensors, the latter those
    whose storage an argument's tensor had."""
    mode = TallyMode()
    # weak references: a donated argument's storage may die in the step,
    # and a new storage may then take its id
    arg_storages = {id(st): weakref.ref(st) for st in
                    (t.untyped_storage() for t in _tensors((args, kwargs)))}
    mode.costs.argument_bytes = mode.track((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    costs = mode.finish()
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        costs.output_bytes += st.nbytes()
        ref = arg_storages.get(id(st))
        if ref is not None and ref() is st:
            costs.alias_bytes += st.nbytes()
    return out, costs


# ---------------------------------------------------------------------------
# The 2-D mesh's collective axes (repro/launch/hlo_analysis.py:317-446)
# ---------------------------------------------------------------------------


def _axis_of_groups(groups: list, m: int) -> str:
    """'model' when every group's ranks share r // m, 'agents' when they
    share r % m, 'mixed' otherwise; 'single' for groups of one."""
    axes = set()
    for g in groups:
        if len(g) <= 1:
            continue
        if all(i // m == g[0] // m for i in g):
            axes.add("model")
        elif all(i % m == g[0] % m for i in g):
            axes.add("agents")
        else:
            axes.add("mixed")
    if not axes:
        return "single"
    return axes.pop() if len(axes) == 1 else "mixed"


def _axis_of_pairs(pairs: list, m: int) -> str:
    """The same rules for (source, target) pairs of global ranks."""
    axes = set()
    for s, t in pairs:
        if s == t:
            continue
        if s // m == t // m:
            axes.add("model")
        elif s % m == t % m:
            axes.add("agents")
        else:
            axes.add("mixed")
    if not axes:
        return "single"
    return axes.pop() if len(axes) == 1 else "mixed"


@dataclasses.dataclass
class CollectiveAxes:
    """One collective of a tally (one group or pair, however many calls)
    with its mesh-axis verdict."""

    kind: str            # all-reduce / reduce-scatter / ...
    axis: str            # agents | model | mixed | single | unknown
    groups: list | None  # its group's global ranks (None for a pair)
    pairs: list | None   # [(source, target)] (collective-permute)


def collective_axes(costs: OpCosts, n_agent_shards: int,
                    n_model_shards: int) -> list[CollectiveAxes]:
    """Classify every collective of ``costs`` (a :func:`tally`'s) against
    the (A, M) mesh: a group by :func:`_axis_of_groups`, a send or
    receive by :func:`_axis_of_pairs`; a collective with no group is
    'unknown'."""
    m = int(n_model_shards)
    if n_agent_shards < 1 or m < 1:
        raise ValueError(f"need a mesh of A, M >= 1, got "
                         f"({n_agent_shards}, {n_model_shards})")
    out = []
    for kind, ranks, pair in costs.collective_groups:
        if pair is not None:
            out.append(CollectiveAxes(kind, _axis_of_pairs([pair], m), None,
                                      [pair]))
        elif ranks:
            out.append(CollectiveAxes(kind, _axis_of_groups([list(ranks)], m),
                                      [list(ranks)], None))
        else:
            out.append(CollectiveAxes(kind, "unknown", None, None))
    return out


def axis_separation(costs: OpCosts, n_agent_shards: int,
                    n_model_shards: int) -> dict[str, list[str]]:
    """Axis -> the sorted collective kinds found on it.  The 2-D engine's
    contract: no 'mixed' or 'unknown', the gossip kinds (reduce-scatter,
    collective-permute) on 'agents' only, and 'model' carrying the line-4
    all-gather (and int8's scale all-reduce)."""
    rep: dict[str, set] = {}
    for c in collective_axes(costs, n_agent_shards, n_model_shards):
        rep.setdefault(c.axis, set()).add(c.kind)
    return {k: sorted(v) for k, v in rep.items()}


# ---------------------------------------------------------------------------
# Chrome traces exported by torch.profiler on the card
# ---------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


# the device names of the prefill kernels #15-#17 (kernels/csrc)
_ZOO_KERNELS = ("::tc::kernel", "::f32::kernel", "chunk_state_kernel",
                "state_pass_kernel", "chunk_output_kernel",
                "rglru_scan_kernel")


def kernel_group(event: dict) -> str:
    """The group of one device event: the port's mix kernels (#1-#14) and
    prefill kernels (#15-#17), cuBLAS matmuls, elementwise, reductions,
    NCCL, copies and sets, other."""
    name = event["name"].lower()
    if event["cat"] != "kernel":
        return "copies and sets"
    if "feddec" in name:
        return "mix kernel (csrc)"
    if any(k in name for k in _ZOO_KERNELS):
        return "zoo kernel (csrc)"
    if "nccl" in name:
        return "nccl"
    if any(s in name for s in ("gemm", "cutlass", "xmma", "sm90_",
                               "nvjet")):
        return "matmul (cuBLAS)"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    if "reduce" in name or "softmax" in name:
        return "reductions"
    return "other"


def device_events(source) -> list:
    """The device events (kernels, copies, sets) of a Chrome trace: a
    path, a loaded trace dict or a list of events."""
    if isinstance(source, (str, Path)):
        source = json.loads(Path(source).read_text())
    events = source["traceEvents"] if isinstance(source, dict) else source
    return [e for e in events if e.get("cat") in _DEVICE_CATS]


_DTYPE_SIZES = {"Float": 4, "Double": 8, "BFloat16": 2, "Half": 2,
                "Int": 4, "Long": 8, "Char": 1, "Byte": 1, "Bool": 1}


@dataclasses.dataclass
class TraceCosts:
    """Device time of one profiled run (milliseconds)."""

    events: int
    device_ms: float
    span_ms: float
    busy_share: float
    groups_ms: dict
    names: dict                      # name -> [ms, count]
    idle_gaps_ms: list               # the longest gaps, longest first
    nccl: dict                       # kernel name -> [ms, count]
    comm_bytes: dict                 # collective name -> bytes


def analyze_trace(source, gaps: int = 5) -> TraceCosts:
    """Device time by kernel name and group, busy share over the span from
    the first device event's start to the last one's end, the ``gaps``
    longest idle gaps, NCCL kernels and the bytes of the collectives the
    ``record_param_comms`` events name."""
    if isinstance(source, (str, Path)):
        source = json.loads(Path(source).read_text())
    all_events = source["traceEvents"] if isinstance(source, dict) \
        else source
    events = device_events(all_events)
    groups: dict = {}
    names: dict = {}
    nccl: dict = {}
    for e in events:
        ms = e["dur"] / 1e3
        g = kernel_group(e)
        groups[g] = groups.get(g, 0.0) + ms
        row = names.setdefault(e["name"][:100], [0.0, 0])
        row[0] += ms
        row[1] += 1
        if g == "nccl":
            r = nccl.setdefault(e["name"][:100], [0.0, 0])
            r[0] += ms
            r[1] += 1
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    merged: list = []
    for lo, hi in intervals:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy = sum(hi - lo for lo, hi in merged) / 1e3
    span = (merged[-1][1] - merged[0][0]) / 1e3 if merged else 0.0
    idle = sorted(((b[0] - a[1]) / 1e3 for a, b in zip(merged, merged[1:])),
                  reverse=True)[:gaps]
    comm: dict = {}
    for e in all_events:
        if e.get("name") != "record_param_comms":
            continue
        a = e.get("args", {})
        kind = a.get("Collective name", "?")
        elems = a.get("Out msg nelems", a.get("In msg nelems", 0)) or 0
        size = _DTYPE_SIZES.get(str(a.get("dtype", "")), 0)
        comm[kind] = comm.get(kind, 0) + int(elems) * size
    return TraceCosts(events=len(events),
                      device_ms=sum(groups.values()), span_ms=span,
                      busy_share=busy / span if span else 0.0,
                      groups_ms=groups, names=names, idle_gaps_ms=idle,
                      nccl=nccl, comm_bytes=comm)
