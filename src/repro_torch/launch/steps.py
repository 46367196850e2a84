"""Step makers binding (architecture × shape × mesh) to the port's step
functions (repro/launch/steps.py).

Three step kinds, matching the assigned shapes:

  * train  (train_4k)    — the FedDec step (Alg. 1) over the agents'
    parameters: line 4 vmapped over the agent rows, the local update, the
    gossip mix, the periodic server round;
  * prefill (prefill_32k) — one forward over the whole sequence on the
    serving parameters (bf16);
  * decode (decode_32k, long_500k) — one-token serve step against KV /
    state caches of length seq_len.

A :class:`Lowerable` is the record of one such step: a maker of the step
function, its argument structs (meta tensors in the step's own containers,
and a ``ShapeDraws`` for its draws), the reference's partition specs of
its arguments and outputs (sharding/__init__.py, held to the reference's
leaf by leaf), the donated arguments and the name.  ``Lowerable.lower``
traces the step once on meta tensors under launch/trace_analysis.py's
tally: the port's counterpart of ``jit(...).lower``; launch/dryrun.py owns
the sweep and launch/train.py the real training loop.

The records keep the reference's mesh (names, sizes, agent counts from
``sharding.n_agents_for``, specs), and the traced program is the one the
port runs:

  * the tree layout on a mesh with a model axis of M > 1 (or under the
    'permute' gossip): the reference's partitioned program, rank 0 of a
    world of ``data_size · M`` ranks on a 2-D ('agents', 'model')
    ``DeviceMesh``, one agent block a mesh row, every leaf its
    ``sharding.param_pspecs`` block and the model's compute
    tensor-parallel over the model group (core/sharded.py
    ``make_sharded_tree_step``, sharding/tp.py; the text transformers,
    GQA or MLA with a dense MLP or an MoE; the others raise
    NotImplementedError);
  * the tree layout otherwise, and the flat layout: one card holding all
    n agents;
  * the sharded layout: rank 0 of a world of ``data_size`` ranks, one
    agent block a rank; with ``mesh_model=M > 1`` (and a model axis in
    the reference's mesh) the 2-D flat engine, rank 0 of ``data_size ·
    M`` ranks, its block the (n/A, D/M) column block (core/sharded.py),
    each model rank gathering its rows for line 4;
  * prefill and decode: one whole serving replica a card, at
    ``global_batch / data_size`` requests where that divides, else the
    whole batch.

The worlds are over ``torch.distributed``'s ``fake`` backend, which this
module creates and destroys around the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import ArchConfig, FedConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import feddec
from repro_torch.core import flat as flat_lib
from repro_torch.core import sweep as sweep_lib
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws, ShapeDraws, SweepDraws
from repro_torch.core.feddec import FedDecConfig
from repro_torch.core.mixing import MixingDistribution
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.trace_analysis import OpCosts, tally
from repro_torch.models import build_model
from repro_torch import sharding as shd
from repro_torch.tree import tree_map

__all__ = ["build_fed_setup", "sweep_lattice_configs", "adapt_for_mesh",
           "flat_2d_config",
           "Lowerable", "Lowered", "build_train_lowerable",
           "build_prefill_lowerable", "build_decode_lowerable",
           "build_lowerable", "TRACE_DEVICE"]

# The dry run's tensors: the meta device, which the kernel wrappers route
# to their ops' fakes (kernels/ops.py).  A CPU-only build of torch cannot
# index a fake CUDA tensor (its device guard needs CUDA), so meta stands
# for the card on every build alike.
TRACE_DEVICE = torch.device("meta")


def build_fed_setup(cfg: ArchConfig, axes: shd.MeshAxes,
                    fed: FedConfig | None = None
                    ) -> tuple[FedDecConfig, int]:
    """(FedDecConfig, n_agents) for this arch on this mesh
    (repro/launch/steps.py:56-84): the agent count from the arch's layout
    (``sharding.n_agents_for``: the data axes' size, or the replicated
    layout's own count), the graph family, Metropolis mixing with link
    failures, and K capped at n."""
    n = shd.n_agents_for(cfg, axes)
    fed = fed or FedConfig()
    if fed.graph.startswith("ring"):
        k = int(fed.graph[4:] or 2)
        graph = topo.ring_graph(n, k=min(k, (n - 1) // 2 or 1))
    elif fed.graph == "full":
        graph = topo.fully_connected_graph(n)
    elif fed.graph.startswith("geo"):
        graph = topo.geographic_graph(n, float(fed.graph[3:]), seed=0)
    elif fed.graph.startswith("er"):
        graph = topo.erdos_renyi_graph(n, float(fed.graph[2:]), seed=0)
    else:
        raise ValueError(f"unknown graph {fed.graph!r}")
    mixing = MixingDistribution(graph, p_fail=fed.p_fail,
                                scheme="metropolis")
    # 'permute' is a gossip_fn built on the mesh (gossip.make_permute_gossip),
    # not a FedDecConfig impl: the config falls back to dense there
    impl = "dense" if fed.gossip_impl == "permute" else fed.gossip_impl
    fcfg = FedDecConfig(mixing=mixing, h=fed.h, k=min(fed.k, n),
                        gossip_impl=impl,
                        gossip_compress=fed.gossip_compress,
                        delta=fed.delta)
    return fcfg, n


def sweep_lattice_configs(fcfg: FedDecConfig, fed: FedConfig | None,
                          sweep_runs: int,
                          sweep_axis: str = "seed") -> list:
    """Per-run FedDecConfigs for a --sweep-runs lattice
    (repro/launch/steps.py:86-122).

    ``seed``     — R replicas of the base config (the runs differ only in
                   their random draws);
    ``h``        — doubling server-period lattice H·{1, 2, 4, …};
    ``topology`` — R independent draws of the base graph family (geo/er
                   re-drawn with seed = run index; deterministic families
                   have nothing to sweep and are rejected).
    """
    fed = fed or FedConfig()
    if sweep_axis == "seed":
        return [fcfg] * sweep_runs
    if sweep_axis == "h":
        return [dataclasses.replace(fcfg, h=fcfg.h * (1 << r))
                for r in range(sweep_runs)]
    if sweep_axis == "topology":
        n = fcfg.n_agents
        if fed.graph.startswith("geo"):
            graphs = [topo.geographic_graph(n, float(fed.graph[3:]), seed=r)
                      for r in range(sweep_runs)]
        elif fed.graph.startswith("er"):
            graphs = [topo.erdos_renyi_graph(n, float(fed.graph[2:]), seed=r)
                      for r in range(sweep_runs)]
        else:
            raise ValueError(
                f"--sweep-axis topology needs a random graph family "
                f"(geoR/erP), got {fed.graph!r}")
        return [dataclasses.replace(
            fcfg, mixing=MixingDistribution(g, p_fail=fed.p_fail,
                                            scheme="metropolis"))
            for g in graphs]
    raise ValueError(f"unknown sweep_axis {sweep_axis!r}; choose "
                     f"seed|h|topology")


def adapt_for_mesh(cfg: ArchConfig, axes: shd.MeshAxes) -> ArchConfig:
    """The reference's mesh-dependent config tweaks
    (repro/launch/steps.py:42-53): ``attn_weight_gather`` where a GQA
    config's heads do not divide the model axis (its attention then
    gathers the weights on use and splits the sequence,
    models/attention.py), and ``tp_axis_name``, the mesh dim whose
    ambient model group (sharding/tp.py) partitions the model's compute.
    Without an ambient group of more than one rank the model computes as
    on one card."""
    if (cfg.attention_kind == "gqa"
            and cfg.num_heads % axes.model_size != 0):
        cfg = dataclasses.replace(cfg, attn_weight_gather=True)
    return dataclasses.replace(cfg, tp_axis_name=axes.model_axis)


def flat_2d_config(cfg: ArchConfig, n_model: int) -> ArchConfig:
    """The config the 2-D flat engine (``n_model`` M > 1 model ranks)
    trains: the reference's 2-D grad runs without the chunked prefill,
    whose scan's stacked outputs cannot cross the partially-auto region
    of its partitioner (repro/launch/steps.py:336-344,
    repro/launch/train.py:214-219)."""
    if n_model > 1:
        return dataclasses.replace(cfg, attn_chunked_prefill=False)
    return cfg


# ---------------------------------------------------------------------------
# argument structs
# ---------------------------------------------------------------------------


def _map(fn, obj):
    """``fn`` over the tensors of a step's arguments (dicts, lists,
    tuples, the engines' state dataclasses, ShapeDraws); the rest as is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, ShapeDraws):
        return obj
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _on(device):
    def make(obj):
        if isinstance(obj, ShapeDraws):
            return ShapeDraws(device, obj.r_runs)
        return _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), obj)
    return make


@dataclasses.dataclass
class Lowered:
    """One traced step: its costs, the seconds the trace took, and its
    outputs' structs (meta tensors)."""

    name: str
    costs: OpCosts
    trace_s: float
    outputs: Any


@contextlib.contextmanager
def _fake_world(world: int):
    """rank 0 of a ``world``-rank group over the ``fake`` backend, for the
    cpu and meta devices, destroyed on exit (a group already running is
    refused: the trace must not join a real one)."""
    import torch.distributed as dist
    if world <= 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world needs no process group "
                           "to be running")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Lowerable:
    """A step function plus everything needed to trace it.

    ``make_fn(device)`` builds the step (its fixed W, ELL tables and
    device constants on ``device``); ``args_struct`` are its arguments as
    meta tensors in the step's containers, with a ``ShapeDraws`` for the
    draws; ``make_args(device, seed)``, where given, makes real arguments
    (random weights, tokens in the vocabulary, seeded draws) for a run on
    ``device``.  ``world`` is the number of ranks (one card each) the
    traced program runs in; its rank 0 is traced."""

    make_fn: Callable
    args_struct: tuple
    in_specs: tuple
    out_specs: Any = None
    donate_argnums: tuple = ()
    name: str = "step"
    make_args: Callable | None = None
    world: int = 1

    def args_on(self, device) -> tuple:
        """The argument structs as uninitialised tensors on ``device``."""
        return tuple(_on(torch.device(device))(a) for a in self.args_struct)

    def lower(self, device=TRACE_DEVICE) -> Lowered:
        """Trace the step once on ``device`` (meta: shapes only) under the
        tally; the world of ``world`` fake ranks around it."""
        with _fake_world(self.world):
            fn = self.make_fn(torch.device(device))
            args = self.args_on(device)
            t0 = time.perf_counter()
            out, costs = tally(fn, *args)
            trace_s = time.perf_counter() - t0
            del args
        return Lowered(self.name, costs, trace_s, _map(_meta, out))


def _microbatch_grad(base_grad: Callable, num_micro: int) -> Callable:
    """Gradient accumulation: split the agent's batch into ``num_micro``
    microbatches taken one after another (a loop, where the reference
    scans), averaging loss and gradients; the gradients accumulate in f32
    (repro/launch/steps.py:146-182).

    This bounds live activations to one microbatch.  An M-RoPE config's
    ``mrope_positions`` (3, B, S) split on their batch dim, one deeper.
    """
    if num_micro <= 1:
        return base_grad

    def split(name: str, x: torch.Tensor) -> torch.Tensor:
        bd = 1 if name == "mrope_positions" else 0
        assert x.shape[bd] % num_micro == 0, (name, x.shape, num_micro)
        shape = (x.shape[:bd] + (num_micro, x.shape[bd] // num_micro)
                 + x.shape[bd + 1:])
        return torch.movedim(x.reshape(shape), bd, 0)

    def grad_fn(params, batch):
        micro = {k: split(k, v) for k, v in batch.items()}
        loss_acc = None
        grad_acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(num_micro):
            loss, grads = base_grad(params, {k: v[i]
                                             for k, v in micro.items()})
            grad_acc = tree_map(lambda a, g: a + g.to(a.dtype), grad_acc,
                                grads)
            loss_acc = loss if loss_acc is None else loss_acc + loss
        inv = 1.0 / num_micro
        return loss_acc * inv, tree_map(lambda g: g * inv, grad_acc)

    return grad_fn


def _default_microbatches(cfg: ArchConfig, per_agent_batch: int,
                          axes: shd.MeshAxes) -> int:
    """num_micro so that about one sequence a device is live a
    microbatch (repro/launch/steps.py:185-195)."""
    if cfg.fed_agent_layout == "sharded":
        per_device = per_agent_batch            # batch replicated over model
    else:
        per_device = max(1, per_agent_batch // axes.data_size)
    m = min(per_agent_batch, per_device)
    while per_agent_batch % m:
        m -= 1
    return max(1, m)


def _agent_ax(axes: shd.MeshAxes):
    return axes.data_axes if len(axes.data_axes) > 1 else axes.data_axes[0]


def _lead(struct, lead: tuple):
    """Every tensor of ``struct`` with ``lead`` dims prepended."""
    return _map(lambda t: torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                                      device="meta"), struct)


def _map_specs(fn, specs):
    """``fn`` over the specs (tuples) of a dict of them."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def build_train_lowerable(cfg: ArchConfig, shape: ShapeConfig,
                          axes: shd.MeshAxes, *,
                          fed: FedConfig | None = None,
                          lr: float = 1e-2,
                          microbatches: int | None = None,
                          mesh: Any = None,
                          fused_steps: int | None = None,
                          state_layout: str = "tree",
                          mesh_model: int | None = None,
                          sweep_runs: int | None = None,
                          sweep_axis: str = "seed",
                          fuse_update_mix: bool = False,
                          optimizer: str = "sgd",
                          remat: bool = True) -> Lowerable:
    """The FedDec training step at ``shape`` (repro/launch/steps.py:
    198-490), with the reference's arguments, checks and messages.

    ``fused_steps=H`` builds the H-step round (batches gain a leading
    (H,) dim, metrics come back stacked); ``state_layout`` picks the tree
    engine, the flat (n, D) buffer or the agent-sharded engine (``mesh``
    required and the sharded agent layout; rank 0 of ``data_size`` ranks
    is traced, or with ``mesh_model=M > 1`` rank 0 of the 2-D engine's
    ``data_size · M``); ``sweep_runs=R`` the R-run lattice of ``sweep_axis``
    (flat or sharded, with ``fused_steps``); ``fuse_update_mix`` the fused
    update+mix kernels (flat).  ``mesh`` is the mesh the record names
    (any object: the port checks only that there is one where the
    reference needs one).  The tree layout with a mesh whose model axis
    is M > 1 traces the reference's partitioned program: rank 0 of
    ``data_size · M`` ranks, every leaf placed by ``param_pspecs`` and
    the model tensor-parallel (a family whose tensor-parallel compute is
    not ported raises NotImplementedError and names its ROADMAP item).
    ``fed.gossip_impl='permute'`` needs the mesh and the sharded agent
    layout, as in the reference; on the tree it traces that world with
    ``gossip.make_permute_gossip(leaf_specs=...)`` as the engine's gossip
    (repro/launch/steps.py:291-305); its one-agent-a-rank block is no
    program the flat engine runs (NotImplementedError).  ``optimizer``
    (the port's addition: sgd, momentum or adamw) runs on the tree and
    flat layouts.  ``remat`` (the reference's default) rematerialises
    each scanned group in line 4's backward; False, the port's addition,
    keeps every activation (what remat saves, measured).
    """
    # mesh_model > 1 opts the sharded layout into the 2-D engine: the flat
    # buffer's D dim column-shards over M model ranks as well
    n_model = mesh_model if state_layout == "sharded" and mesh_model \
        and mesh_model > 1 and axes.model_size > 1 else 1
    cfg = flat_2d_config(adapt_for_mesh(cfg, axes), n_model)
    model = build_model(cfg)
    fcfg, n_agents = build_fed_setup(cfg, axes, fed)
    compress = fcfg.gossip_compress if fcfg.gossip_impl != "none" else "none"
    per_agent = shape.global_batch // n_agents
    if microbatches is None:
        microbatches = _default_microbatches(cfg, per_agent, axes)
    grad_fn = _microbatch_grad(model.grad_fn(remat=remat), microbatches)
    opt = {"sgd": None, "momentum": optim.momentum_sgd(),
           "adamw": optim.adamw()}[optimizer]

    params_struct = model.init_shapes()
    batch_struct = specs_lib.train_batch_specs(cfg, shape, n_agents)
    batch_specs = shd.batch_pspecs(cfg, batch_struct, axes, stacked=True)
    agent_ax = _agent_ax(axes)
    name = f"train:{cfg.name}:{shape.name}"

    permute = fed is not None and fed.gossip_impl == "permute"
    if permute:
        if mesh is None or cfg.fed_agent_layout != "sharded":
            raise ValueError("permute gossip needs a mesh and the sharded "
                             "agent layout")
        if state_layout != "tree":
            raise NotImplementedError(
                "permute gossip moves one agent a rank; the port's flat "
                "engine holds its agents on one card (or in the sharded "
                "engine's blocks: state_layout='sharded', gossip_impl="
                "'sparse')")
    if state_layout not in ("tree", "flat", "sharded"):
        raise ValueError(f"state_layout must be 'tree', 'flat' or "
                         f"'sharded', got {state_layout!r}")
    if fuse_update_mix and state_layout != "flat":
        raise ValueError(
            "fuse_update_mix needs the flat (n, D) buffer layout "
            "(state_layout='flat'); the sharded engine overlaps its halo "
            "with interior compute instead (core/sharded.py)")

    lr_fn = _lr_fn(lr)
    world = 1
    if state_layout == "sharded":
        if mesh is None or cfg.fed_agent_layout != "sharded":
            raise ValueError("state_layout='sharded' needs a mesh and the "
                             "sharded agent layout")
        if optimizer != "sgd":
            raise ValueError("optimizer state is not threaded through the "
                             "sharded lowerable yet")
        n_shards = axes.data_size
        world = n_shards * n_model
        if n_agents % n_shards:
            raise ValueError(f"n_agents={n_agents} must be divisible by "
                             f"the data axes' {n_shards} ranks")
        n_local = n_agents // n_shards
        # D % M is the maker's check (core/sharded.py:_validate_model_axis)
        spec = flat_lib.make_flat_spec(params_struct)
        model_ax = axes.model_axis if n_model > 1 else None

        def init_state(params):
            return _rows(flat_lib.init_flat_state(
                spec, params, n_agents, compress=compress), n_local,
                cols=spec.d // n_model)
        state_specs = flat_lib.FlatFedState(
            flat=(agent_ax, model_ax), step=(), opt_state=(),
            residual=() if compress == "none" else (agent_ax, model_ax))
        batch_struct = _map(lambda t: torch.empty(
            (n_local,) + tuple(t.shape[1:]), dtype=t.dtype, device="meta"),
            batch_struct)

        def make_engine(maker_name):
            def make(device):
                from repro_torch.core import sharded as sharded_lib
                from repro_torch.launch.mesh import (make_agent_mesh,
                                                     make_fed_mesh)
                if n_model > 1:
                    dmesh = make_fed_mesh(n_shards, n_model,
                                          device=device.type)
                    kw = dict(model_axis="model")
                else:
                    dmesh = make_agent_mesh(world, device=device.type)
                    kw = {}
                return getattr(sharded_lib, maker_name)(
                    fcfg, spec, grad_fn, lr_fn(device), dmesh,
                    device=device, **kw)
            return make

        make_step = make_engine("make_sharded_feddec_step")
        make_round = make_engine("make_sharded_feddec_round")
        name += ":sharded" + (f":m{n_model}" if n_model > 1 else "")
    elif state_layout == "flat":
        spec = flat_lib.make_flat_spec(params_struct)

        def init_state(params):
            return flat_lib.init_flat_state(spec, params, n_agents,
                                            optimizer=opt, compress=compress)

        state_struct = init_state(params_struct)
        flat_spec_p = (agent_ax, None) \
            if cfg.fed_agent_layout == "sharded" else (None, None)
        state_specs = flat_lib.FlatFedState(
            flat=flat_spec_p, step=(),
            opt_state=() if opt is None else _opt_specs(
                state_struct.opt_state, flat_spec_p),
            residual=() if compress == "none" else flat_spec_p)

        def make_flat(maker):
            return lambda device: maker(
                fcfg, spec, grad_fn, lr_fn(device), device=device,
                optimizer=opt, fuse_update_mix=fuse_update_mix)

        make_step = make_flat(flat_lib.make_flat_feddec_step)
        make_round = make_flat(flat_lib.make_flat_feddec_round)
        name += ":flat"
        if fuse_update_mix:
            name += ":updmix"
    else:
        def init_state(params):
            return feddec.init_state(params, n_agents, optimizer=opt,
                                     compress=compress)

        state_struct = init_state(params_struct)
        param_specs = shd.param_pspecs(cfg, state_struct.params, axes)
        state_specs = feddec.FedState(
            params=param_specs, step=(),
            opt_state=() if opt is None else _opt_specs(
                state_struct.opt_state, param_specs),
            residual=() if compress == "none" else param_specs)

        def make_tree(maker):
            return lambda device: maker(fcfg, grad_fn, lr_fn(device),
                                        optimizer=opt, device=device)

        make_step = make_tree(feddec.make_feddec_step)
        make_round = make_tree(feddec.make_feddec_round)
        if mesh is not None and (axes.model_size > 1 or permute):
            # the partitioned program: rank 0 of data_size · model_size
            # ranks on the ('agents', 'model') mesh, every leaf its
            # param_pspecs block, the model's compute tensor-parallel
            world, n_local, init_state, make_step, make_round = \
                _tree_world(cfg, axes, fcfg, n_agents, grad_fn, lr_fn, opt,
                            compress, permute)
            batch_struct = _map(lambda t: torch.empty(
                (n_local,) + tuple(t.shape[1:]), dtype=t.dtype,
                device="meta"), batch_struct)

    if fused_steps is None:
        make_fn = make_step
    else:
        if fused_steps < 1:
            raise ValueError(f"fused_steps must be >= 1, got {fused_steps}")
        make_fn = make_round
        batch_struct = _lead(batch_struct, (fused_steps,))
        batch_specs = _map_specs(lambda sp: (None,) + sp, batch_specs)
        name += f":fused{fused_steps}"

    draws_struct = ShapeDraws("meta")
    r_runs = None
    if sweep_runs:
        if state_layout not in ("flat", "sharded"):
            raise ValueError("sweep_runs lowers the batched sweep engine "
                             "(repro.core.sweep); it requires "
                             "state_layout='flat' or 'sharded'")
        if fused_steps is None:
            raise ValueError("sweep_runs requires the fused executor "
                             "(fused_steps=H)")
        plan = sweep_lib.make_sweep_plan(
            sweep_lattice_configs(fcfg, fed, sweep_runs, sweep_axis))
        n_rows = n_agents // world

        def init_state(params):
            state = sweep_lib.init_sweep_state(plan, spec, params,
                                               optimizer=opt)
            return _rows(state, n_rows, dim=1) if world > 1 else state

        if state_layout == "sharded":
            if n_model > 1:
                from repro_torch.core import engine as engine_lib
                raise engine_lib.model_axis_conflict(
                    "sweep lattices (--sweep-runs) until the composition "
                    "lands")
            state_specs = sweep_lib.SweepFedState(
                flat=(None, agent_ax, None), step=(None,), opt_state=(),
                residual=() if compress == "none"
                else (None, agent_ax, None))

            def make_fn(device):
                from repro_torch.core import sharded as sharded_lib
                from repro_torch.launch.mesh import make_agent_mesh
                dmesh = make_agent_mesh(world, device=device.type)
                return sharded_lib.make_sharded_sweep_round(
                    plan, spec, grad_fn, lr_fn(device), dmesh,
                    device=device)
        else:
            flat_spec_p = state_specs.flat
            state_specs = sweep_lib.SweepFedState(
                flat=(None,) + tuple(flat_spec_p), step=(None,),
                opt_state=() if opt is None else _opt_specs(
                    init_state(params_struct).opt_state,
                    (None,) + tuple(flat_spec_p), (None,)),
                residual=() if compress == "none"
                else (None,) + tuple(flat_spec_p))

            def make_fn(device):
                return sweep_lib.make_sweep_feddec_round(
                    plan, spec, grad_fn, lr_fn(device),
                    device=device, optimizer=opt,
                    fuse_update_mix=fuse_update_mix)
        # batches gain a run axis after the fused-step dim
        batch_struct = _map(lambda t: torch.empty(
            (t.shape[0], sweep_runs) + tuple(t.shape[1:]), dtype=t.dtype,
            device="meta"), batch_struct)
        batch_specs = _map_specs(lambda sp: (sp[0], None) + sp[1:],
                                 batch_specs)
        r_runs = sweep_runs
        draws_struct = ShapeDraws("meta", sweep_runs)
        name += f":sweep{sweep_runs}-{sweep_axis}"

    def make_args(device, seed: int = 0):
        """Real arguments on ``device``: random weights (``Draws(seed)``),
        the engine's initial state (this rank's block in a world), tokens
        uniform in the vocabulary, and seeded draws."""
        draws = Draws(seed, device) if r_runs is None else SweepDraws(
            seed, device, r_runs, per_run=sweep_axis == "seed")
        state = init_state(model.init(draws))
        return state, _concrete(cfg, batch_struct, draws), draws

    return Lowerable(
        make_fn=make_fn,
        args_struct=(init_state(params_struct), batch_struct, draws_struct),
        in_specs=(state_specs, batch_specs, ()),
        out_specs=(state_specs, {"loss": (), "eta": ()}),
        donate_argnums=(0,),
        name=name, make_args=make_args, world=world)


def _tree_world(cfg, axes: shd.MeshAxes, fcfg, n_agents: int, grad_fn,
                lr_fn, opt, compress: str, permute: bool):
    """The tree engine's partitioned program (core/sharded.py:
    make_sharded_tree_step on launch/mesh.make_fed_mesh(A, M), A the data
    axes' size and M the model axis'): (world, n_local, rank 0's
    init_state, make_step, make_round); ``permute`` puts
    gossip.make_permute_gossip with the leaves' specs in the engine
    (repro/launch/steps.py:291-305).  A family whose tensor-parallel
    compute is not ported raises (``tp.check_family``)."""
    from repro_torch.sharding import tp as tp_lib
    a, m = axes.data_size, axes.model_size
    if m > 1:
        tp_lib.check_family(cfg)
    if n_agents % a:
        raise ValueError(f"n_agents={n_agents} must be divisible by the "
                         f"data axes' {a} ranks")
    mesh_axes = shd.MeshAxes(("agents",), "model", {"agents": a, "model": m})
    specs = shd.param_pspecs(
        cfg, feddec.init_state(build_model(cfg).init_shapes(), n_agents,
                               optimizer=opt).params, mesh_axes)
    rank0 = {"agents": (0, a), "model": (0, m)}

    def init_state(params):
        from repro_torch.core import sharded as sharded_lib
        state = feddec.init_state(params, n_agents, optimizer=opt,
                                  compress=compress)
        return sharded_lib.shard_tree_state(state, specs, None,
                                            coords=rank0)

    def make_engine(maker_name):
        def make(device):
            from repro_torch.core import gossip as gossip_lib
            from repro_torch.core import sharded as sharded_lib
            from repro_torch.launch.mesh import make_fed_mesh
            dmesh = make_fed_mesh(a, m, device=device.type)
            gossip_fn = gossip_lib.make_permute_gossip(
                fcfg.mixing.graph, dmesh, "agents", leaf_specs=specs) \
                if permute else None
            return getattr(sharded_lib, maker_name)(
                fcfg, grad_fn, lr_fn(device), dmesh, device=device,
                param_specs=specs, gossip_fn=gossip_fn, optimizer=opt)
        return make

    return (a * m, n_agents // a, init_state,
            make_engine("make_sharded_tree_step"),
            make_engine("make_sharded_tree_round"))


def _lr_fn(lr: float):
    """lr_fn(device) -> the engines' constant η_t, one (1,) f32 tensor on
    ``device`` made once (as launch/train.py's)."""
    def on(device):
        eta = torch.full((1,), lr, dtype=torch.float32, device=device)
        return lambda t: eta
    return on


def _opt_specs(opt_state, spec, count=()):
    """The optimizer buffers' specs: the parameters' (or the flat
    buffer's) for momentum's slot and adamw's ``m`` and ``v``, ``count``
    for adamw's step count."""
    if isinstance(opt_state, dict) and "count" in opt_state:
        return {"m": spec, "v": spec, "count": count}
    return spec


def _rows(state, n_local: int, dim: int = 0, cols: int | None = None):
    """Rank 0's block of a flat (``dim`` 0) or lattice (``dim`` 1)
    state's agent rows (and, with ``cols``, its first ``cols`` columns:
    the 2-D mesh's column block), its own storage (as
    sharded.shard_flat_state)."""
    def cut(t):
        if t.ndim <= dim:
            return t
        t = t.narrow(dim, 0, n_local)
        return (t if cols is None else t.narrow(-1, 0, cols)).clone()
    return _map(cut, state)


def _concrete(cfg, batch_struct, draws):
    """A real batch of ``batch_struct``'s shapes on ``draws.device``:
    tokens uniform in the vocabulary, positions 0 .. S-1, embeddings
    N(0, 1)·0.02."""
    out = {}
    for k, t in batch_struct.items():
        shape = tuple(t.shape)
        if k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, shape,
                                   generator=draws.generator,
                                   device=draws.device)
        elif k in ("positions", "mrope_positions"):
            out[k] = torch.arange(shape[-1], device=draws.device).expand(
                shape).contiguous()
        else:
            out[k] = (draws.normal(shape) * 0.02).to(t.dtype)
    return out


def _serve_batch(shape: ShapeConfig, axes: shd.MeshAxes) -> int:
    """The requests one card's replica serves."""
    b = shape.global_batch
    return b // axes.data_size if b % axes.data_size == 0 else b


def build_prefill_lowerable(cfg: ArchConfig, shape: ShapeConfig,
                            axes: shd.MeshAxes, *,
                            impl: str = "xla") -> Lowerable:
    """Inference prefill: the whole sequence's forward on bf16 serving
    parameters (repro/launch/steps.py:493-531), on one card's replica;
    ``impl='pallas'`` runs the kernels #15–#17."""
    cfg = adapt_for_mesh(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                         axes)
    model = build_model(cfg)
    vocab_ok = cfg.vocab_size % axes.model_size == 0
    batch_ok = shape.global_batch % axes.data_size == 0
    dp = _agent_ax(axes)
    params_struct = model.init_shapes()
    full = specs_lib._specs(specs_lib.batch_schema(
        cfg, None, shape.global_batch, shape.seq_len))
    batch_struct = specs_lib._specs(specs_lib.batch_schema(
        cfg, None, _serve_batch(shape, axes), shape.seq_len))

    def make_fn(device):
        def prefill(params, batch):
            with torch.no_grad():
                return model.logits(params, batch, impl=impl, remat=False)
        return prefill

    def make_args(device, seed: int = 0):
        draws = Draws(seed, device)
        return model.init(draws), _concrete(cfg, batch_struct, draws)

    return Lowerable(
        make_fn=make_fn,
        args_struct=(params_struct, batch_struct),
        in_specs=(shd.serve_param_pspecs(cfg, params_struct, axes),
                  shd.batch_pspecs(cfg, full, axes, stacked=False)),
        out_specs=(dp if batch_ok else None, None,
                   axes.model_axis if vocab_ok else None),
        name=f"prefill:{cfg.name}:{shape.name}",
        make_args=make_args)


def build_decode_lowerable(cfg: ArchConfig, shape: ShapeConfig,
                           axes: shd.MeshAxes) -> Lowerable:
    """One-token decode against a seq_len KV/state cache
    (repro/launch/steps.py:534-571), on one card's replica."""
    cfg = adapt_for_mesh(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                         axes)
    model = build_model(cfg)
    long_variant = shape.needs_subquadratic
    batch = _serve_batch(shape, axes)

    def make_fn(device):
        def serve_step(params, batch, caches):
            enc_out = batch.get("enc_out")
            core = {k: v for k, v in batch.items() if k != "enc_out"}
            with torch.no_grad():
                logits, new_caches = model.decode_step(
                    params, core, caches, enc_out=enc_out,
                    long_variant=long_variant)
                return torch.argmax(logits[:, -1], dim=-1), new_caches
        return serve_step

    params_struct = model.init_shapes()
    full_batch = specs_lib.decode_batch_specs(cfg, shape)
    batch_struct = specs_lib._specs(specs_lib.batch_schema(
        cfg, None, batch, 1, decode=True))
    full_caches = model.init_caches(shape.global_batch, shape.seq_len,
                                    long_variant=long_variant,
                                    device="meta")
    caches_struct = model.init_caches(batch, shape.seq_len,
                                      long_variant=long_variant,
                                      device="meta")
    cache_specs = shd.cache_pspecs(cfg, full_caches, axes)
    dp = _agent_ax(axes)
    tok_spec = (dp if shape.global_batch % axes.data_size == 0 else None,)

    def make_args(device, seed: int = 0):
        draws = Draws(seed, device)
        caches = model.init_caches(batch, shape.seq_len,
                                   long_variant=long_variant, device=device)
        return (model.init(draws), _concrete(cfg, batch_struct, draws),
                caches)

    return Lowerable(
        make_fn=make_fn,
        args_struct=(params_struct, batch_struct, caches_struct),
        in_specs=(shd.serve_param_pspecs(cfg, params_struct, axes),
                  shd.batch_pspecs(cfg, full_batch, axes, stacked=False),
                  cache_specs),
        out_specs=(tok_spec, cache_specs),
        donate_argnums=(2,),
        name=f"decode:{cfg.name}:{shape.name}",
        make_args=make_args)


def build_lowerable(cfg: ArchConfig, shape: ShapeConfig,
                    axes: shd.MeshAxes, **kw) -> Lowerable:
    """The step of ``shape``'s kind; train-only options are dropped for
    the serving steps, as in the reference, and ``impl`` goes to the
    prefill alone."""
    impl = kw.pop("impl", "xla")
    if shape.kind == "train":
        return build_train_lowerable(cfg, shape, axes, **kw)
    if shape.kind == "prefill":
        return build_prefill_lowerable(cfg, shape, axes, impl=impl)
    return build_decode_lowerable(cfg, shape, axes)

