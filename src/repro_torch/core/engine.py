"""The engine dispatcher, the shared Algorithm-1 step body and the gossip
dispatcher (repro/core/engine.py, for the tree, flat and lattice layouts,
on one device or agent-sharded over a 1-D mesh).

  * :class:`EngineSpec` + :func:`parse_engine_spec` — one point of the
    (layout × run-batch × shards × delta × fused update+mix) lattice,
    validated with the reference's messages.
  * :func:`make_engine_step` / :func:`make_engine_round` — lower a spec to
    its executor: the tree engine (core/feddec.py), the flat engine
    (core/flat.py), the sweep lattice (core/sweep.py), or, with a
    ``torch.distributed`` mesh, the agent-sharded flat engine and lattice
    (core/sharded.py).  The per-engine makers (``make_feddec_*``,
    ``make_flat_feddec_*``, ``make_sweep_feddec_*``, ``make_fedavg_*``,
    ``make_sharded_*``) are shims over them.  The 2-D lowering
    (``n_model_shards`` > 1) is not ported and raises
    NotImplementedError.
  * :class:`EngineOps` + :func:`build_step_body` — the one step order:
    η_t → sample W^t (line 3) → local update (lines 4–5) → gossip (line 6,
    compressed with error feedback when a codec is configured) → periodic
    server round (lines 7–12) → carry rebuild.  The fused update+mix op,
    when set, replaces the update + gossip pair.
  * :func:`make_loop_round` — the H-step round as a Python loop over the
    stacked batches (the reference scans it inside one compiled program),
    with the reference's per-step ``metrics_fn`` hook.
  * :func:`resolve_gossip` — gossip_impl → the mixing fn of the tree
    engine's stacked dict (leaf by leaf), the flat buffer or a sweep
    lattice.

Randomness comes from a :class:`repro_torch.core.draws.Draws` object
passed with every call, keyed by the step counter t (the reference folds
t into its step key).

Line 4 is a :data:`GradFn` for one agent, which the engines call once,
batched over every agent row of the buffer (``flat.grads_of``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
# torch.func imports torch._dynamo at its first call, and that import
# leaves reference cycles that hold the frames on the stack at that
# moment: the engine's, with its (n, D) buffers, which then outlive the
# step until the garbage collector runs.  Importing it here, where no
# frame holds a buffer, keeps the first step's peak that of the others.
import torch._dynamo  # noqa: F401

from repro_torch.core import gossip as gossip_lib

__all__ = ["GradFn", "value_and_grad", "GOSSIP_IMPLS", "LAYOUTS",
           "EngineSpec", "EngineOps", "parse_engine_spec",
           "build_step_body", "make_loop_round", "resolve_gossip",
           "check_gossip_impl", "unknown_gossip_impl",
           "model_axis_conflict", "make_engine_step", "make_engine_round",
           "make_population_round", "shard_sweep_state",
           "make_sharded_sweep_step", "make_sharded_sweep_round"]

# Line 4 for ONE agent: (params, batch) -> (loss, grads), params a dict of
# tensors, grads in params' layout, loss a 0-d tensor.  The engines call it
# once under torch.func.vmap over all agent rows, so it must be written in
# ops that torch.func can transform: no .item(), no data-dependent Python
# control flow, no in-place writes to its inputs, no torch.autograd.grad
# (build it with :func:`value_and_grad`, or write the gradient out, as
# the reference's linreg grad_fn does).  The reference's GradFn takes a
# third argument, a PRNG key, which both of its grad_fns discard
# (repro/models/model.py, ``del key``; repro/data/linreg.py): the port
# drops it, and its randomness goes through the Draws object instead.
GradFn = Callable[[dict, dict], tuple]

GOSSIP_IMPLS = ("dense", "none", "pallas", "sparse")
LAYOUTS = ("tree", "flat")


def value_and_grad(loss_fn) -> GradFn:
    """loss_fn(params, batch) -> scalar, as a :data:`GradFn` (the
    reference's ``jax.value_and_grad``), built on
    ``torch.func.grad_and_value`` so that the engines can vmap it."""
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def grad_fn(params, batch):
        grads, loss = grad_and_value(params, batch)
        return loss, grads

    return grad_fn


def unknown_gossip_impl(impl) -> ValueError:
    """THE unknown-gossip_impl error — identical from every entry point."""
    hint = (" (the mesh ppermute path is not a gossip_impl: build it "
            "with gossip.make_permute_gossip and pass gossip_fn=...)"
            if impl == "permute" else "")
    return ValueError(
        f"unknown gossip_impl {impl!r}; choose from "
        f"{'|'.join(GOSSIP_IMPLS)}{hint}")


def check_gossip_impl(impl: str) -> str:
    if impl not in GOSSIP_IMPLS:
        raise unknown_gossip_impl(impl)
    return impl


def model_axis_conflict(feature: str) -> ValueError:
    """THE model-axis incompatibility error — identical from every entry
    point (repro/core/engine.py:109-116)."""
    return ValueError(
        f"model-axis sharding (n_model_shards > 1 / --mesh-model) does "
        f"not compose with {feature}; use n_model_shards=1")


def resolve_gossip(source, layout: str = "flat") -> Callable:
    """gossip_impl → the mixing fn of one engine layout.

    layout 'tree': (w (n, n), stacked dict of (n, ...) leaves) -> dict,
    ``source`` a config (repro/core/engine.py:141-152):
      'dense'  one plain matrix product per leaf, in the leaf's dtype;
      'pallas' kernel #1 once per leaf (kernels.ops.gossip_mix_tree);
      'sparse' the flat layout's sparse mix once per leaf
               (gossip.make_sparse_gossip_tree): kernel #2 per leaf on
               CUDA when 0 < max_deg <= ELL_MAX_DEG;
      'none'   identity (FedAvg).
    layout 'flat': (w (n, n), x (n, D)) -> (n, D), ``source`` a config:
      'dense'  one plain matrix product (the reference leaves it to XLA);
      'pallas' the streaming gossip kernel #1 (kernels.ops.gossip_mix);
      'sparse' the ELL kernel #2 on CUDA / the plain ELL mix on the CPU
               when 0 < max_deg <= ELL_MAX_DEG, else the plain CSR gather;
      'none'   identity (FedAvg).
    layout 'sweep': (w (R, n, n), x (R, n, D)) -> (R, n, D), ``source`` a
    SweepPlan (repro/core/engine.py:177-200):
      'dense'  one batched matrix product;
      'pallas' kernel #5 (kernels.ops.gossip_mix_batched), one launch;
      'sparse' the stacked-ELL kernel #6 when 0 < max_deg <= ELL_MAX_DEG,
               else the plain stacked-ELL mix;
      'none'   identity (an all-FedAvg lattice).
    The kernels (and their plain versions on the CPU) load and store the
    buffer's dtype, f32, f64 or bf16, and sum the mix in f32, as the
    reference's kernels do.  'dense', the CSR gather and the plain stacked ELL round W
    to the buffer's dtype first and mix in that dtype, as the reference's
    plain mixes do (repro/core/gossip.py:60, :205; core/engine.py:157,
    :182); a bf16 buffer's dense product is summed in f32 and rounded
    once, as XLA sums it.
    """
    if layout not in LAYOUTS + ("sweep",):
        raise ValueError(f"engine layout {layout!r} is not ported; the "
                         f"port runs the 'tree' stacked dict, the 'flat' "
                         f"(n, D) buffer and the 'sweep' (R, n, D) lattice")
    impl = source.gossip_impl
    if impl == "none":
        return lambda w, x: x
    if impl == "dense":
        return gossip_lib.gossip_mix_dense
    if impl == "pallas":
        from repro_torch.kernels import ops as kernel_ops
        return {"tree": kernel_ops.gossip_mix_tree,
                "flat": kernel_ops.gossip_mix,
                "sweep": kernel_ops.gossip_mix_batched}[layout]
    if impl == "sparse":
        if layout == "tree":
            return gossip_lib.make_sparse_gossip_tree(source.mixing.graph)
        if layout == "flat":
            return gossip_lib.make_sparse_gossip(source.mixing.graph)
        return gossip_lib.make_sparse_gossip_batched(source.graphs)
    raise unknown_gossip_impl(impl)


@dataclasses.dataclass
class EngineOps:
    """Per-engine vtable consumed by :func:`build_step_body`.

    Fields (Algorithm-1 lines in parentheses):
      get_step:     state -> t (the carried step counter, starts at 1).
      eta_fn:       t -> η_t, a tensor on the buffer's device in the
                    buffer's dtype, at least f32: (1,) on the flat engine
                    (the caller's lr_fn), () on the tree engine (its
                    lr_fn's number or tensor, moved), (R,) on a lattice
                    (the lattice moves and casts its lr_fn's values).
      sample_w:     (draws, t) -> W^t (line 3).
      local_update: (state, batch, eta) -> (losses, x_half, new_opt)
                    (lines 4–5).
      gossip:       (w, x_half) -> x_next (line 6, uncompressed).
      get_residual: state -> the carried EF residual, or () (passed through
                    unchanged when ef_gossip is None).
      ef_gossip:    (w, x_half, residual, draws, t) -> (x_next,
                    new_residual) (line 6 with a codec and error feedback),
                    or None.
      server:       (draws, t, x_next) -> z_next (lines 7–12).
      finish:       (state, z_next, new_opt, new_res, t, losses, eta) ->
                    (new_state, metrics).
      fused_update_gossip: (w, state, batch, eta, residual, draws, t) ->
                    (losses, x_next, new_opt, new_res), or None.  When set
                    it replaces local_update + gossip / ef_gossip with one
                    fused op (the update+mix kernels #3/#4, or the EF mix
                    #9/#11 under a codec; on a lattice #7/#8, #10/#12).
    """

    get_step: Callable
    eta_fn: Callable
    sample_w: Callable
    local_update: Callable
    gossip: Callable
    get_residual: Callable
    server: Callable
    finish: Callable
    ef_gossip: Callable | None = None
    fused_update_gossip: Callable | None = None


def build_step_body(ops: EngineOps):
    """The Algorithm-1 step: step(state, batch, draws) -> (state, metrics)."""
    def step(state, batch, draws):
        t = ops.get_step(state)
        eta = ops.eta_fn(t)
        w = ops.sample_w(draws, t)                       # line 3
        residual = ops.get_residual(state)
        if ops.fused_update_gossip is not None:
            # lines 4–6 in one buffer pass (kernels #3/#4, #7–#12)
            losses, x_next, new_opt, new_res = ops.fused_update_gossip(
                w, state, batch, eta, residual, draws, t)
        else:
            losses, x_half, new_opt = ops.local_update(state, batch, eta)
            if ops.ef_gossip is None:                    # line 6
                x_next, new_res = ops.gossip(w, x_half), residual
            else:  # line 6 on the compressed payload, error feedback
                x_next, new_res = ops.ef_gossip(w, x_half, residual, draws,
                                                t)
            del x_half  # an (n, D) buffer: not held through the server
        del residual
        z_next = ops.server(draws, t, x_next)            # lines 7–12
        return ops.finish(state, z_next, new_opt, new_res, t, losses, eta)

    return step


def make_loop_round(step, metrics_fn=None):
    """round_fn(state, batches, draws): ``step`` over the leading axis of
    every batch leaf; each metric stacks to (H,) + its per-step shape.
    ``metrics_fn`` (state -> dict), when given, is evaluated on the state
    after every step and merged into that step's metrics (the reference's
    ``make_scan_round`` hook, repro/core/engine.py:319-340)."""
    def round_fn(state, batches, draws):
        steps = next(iter(batches.values())).shape[0]
        per_step = []
        for h in range(steps):
            batch = {k: v[h] for k, v in batches.items()}
            state, metrics = step(state, batch, draws)
            if metrics_fn is not None:
                metrics = {**metrics, **metrics_fn(state)}
            per_step.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_step])
                   for k in per_step[0]}
        return state, stacked

    return round_fn


def make_population_round(spec, flat_spec, grad_fn: GradFn, lr_fn, **kwargs):
    """The population engine's cohort round (repro/core/engine.py:350-363).

    ``spec`` is a :class:`repro_torch.core.population.PopulationSpec`;
    the result is ``round_fn(state, batches, draws, mix)``, the shared
    Algorithm-1 body (:func:`build_step_body`) with the mix swapped for
    the round's cohort-subgraph tables (kernel #2 on CUDA).  The
    host↔device stream around it is
    :class:`repro_torch.core.population.PopulationEngine`.  ``device`` is
    a required keyword, as on every maker.
    """
    from repro_torch.core import population as population_lib
    return population_lib.make_cohort_round(spec, flat_spec, grad_fn, lr_fn,
                                            **kwargs)


# ---------------------------------------------------------------------------
# EngineSpec: the configuration lattice
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One point of the (layout × run-batch × shards × delta × fused
    update+mix) lattice (repro/core/engine.py:372-450).

    Attributes:
      configs: one FedDecConfig per run; len > 1 is a sweep lattice.
      layout: 'tree' (the stacked dict, one run) or 'flat' (the (n, D)
        buffer that runs batch over).
      n_shards / axis_name: agent-axis shards and their mesh axis.
      n_model_shards / model_axis: model-axis shards per agent row.
        Parsed as the reference parses them; lowering a model axis above
        1 is not ported.
      t_steps: optional per-run step budgets (sweep freeze masking).
      force_run_axis: keep the run axis for a single run (the sweep
        makers' R = 1 plans).
      delta: the configs' shared delta parameterization (core/delta.py):
        'none' | 'full' | 'topk:K' | 'lowrank:R'; non-'none' lowers on the
        single-run flat engine only.
      fuse_update_mix: run lines 5–6 as one fused pass (flat / sweep).
    """

    configs: tuple
    layout: str = "flat"
    n_shards: int = 1
    axis_name: Any = "agents"
    t_steps: tuple | None = None
    force_run_axis: bool = False
    delta: str = "none"
    n_model_shards: int = 1
    model_axis: Any = "model"
    fuse_update_mix: bool = False

    @property
    def cfg(self):
        return self.configs[0]

    @property
    def r_runs(self) -> int:
        return len(self.configs)

    @property
    def has_run_axis(self) -> bool:
        return self.r_runs > 1 or self.force_run_axis

    @property
    def is_sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def is_model_sharded(self) -> bool:
        return self.n_model_shards > 1

    def plan(self):
        """The validated SweepPlan of this spec's run lattice."""
        from repro_torch.core import sweep as sweep_lib
        t = None if self.t_steps is None else np.asarray(self.t_steps,
                                                         np.int32)
        return sweep_lib.make_sweep_plan(self.configs, t_steps=t)


def parse_engine_spec(configs, layout: str = "flat", n_shards: int = 1,
                      axis_name="agents", t_steps=None,
                      force_run_axis: bool = False, n_model_shards: int = 1,
                      model_axis="model",
                      fuse_update_mix: bool = False) -> EngineSpec:
    """Validate and freeze an EngineSpec (repro/core/engine.py:453-548),
    with the reference's checks and messages.

    ``configs`` is one FedDecConfig or an iterable of them.  Parsing is
    pure validation: a model-sharded spec parses as in the reference, and
    only its lowering is not ported.
    """
    if hasattr(configs, "gossip_impl"):  # a single config
        configs = (configs,)
    configs = tuple(configs)
    if not configs:
        raise ValueError("engine spec needs at least one run config")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown engine layout {layout!r}; choose from "
                         f"{'|'.join(LAYOUTS)}")
    if layout == "tree":
        if len(configs) > 1 or force_run_axis:
            raise ValueError("layout 'tree' lowers a single run; use "
                             "layout='flat' for sweep lattices")
        if n_shards > 1:
            raise ValueError("layout 'tree' does not shard the agent axis; "
                             "use layout='flat' with a mesh")
    n = configs[0].n_agents
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"n_agents={n} must be divisible by the agent axis "
                         f"size {n_shards} (block-sharded rows)")
    if t_steps is not None:
        t_steps = tuple(int(t) for t in np.asarray(t_steps).reshape(-1))
    delta = getattr(configs[0], "delta", "none")
    if any(getattr(c, "delta", "none") != delta for c in configs):
        raise ValueError("all runs of an engine lattice must share one "
                         "delta parameterization")
    if delta != "none":
        if layout == "tree":
            raise ValueError(
                "delta parameterization needs the flat (n, D) layout — the "
                "base row and encoded payloads are whole-buffer objects; "
                "use layout='flat'")
        if len(configs) > 1 or force_run_axis:
            raise ValueError(
                "delta parameterization is single-run: the sweep lattice "
                "shares one state buffer per run and does not thread the "
                "per-run base rows")
        if n_shards > 1:
            raise ValueError(
                "delta parameterization lowers on the single-device flat "
                "engine (the sharded halo exchanges dense row blocks); "
                "use n_shards=1 or delta='none'")
    if n_model_shards < 1:
        raise ValueError(f"n_model_shards must be >= 1, got {n_model_shards}")
    if n_model_shards > 1:
        if layout == "tree":
            raise model_axis_conflict(
                "layout 'tree' (the pytree engine has no flat buffer to "
                "column-shard)")
        if len(configs) > 1 or force_run_axis:
            raise model_axis_conflict(
                "sweep lattices (--sweep-runs) until the composition lands")
        if delta != "none":
            raise model_axis_conflict("delta parameterization (--delta)")
        c0 = configs[0]
        if (getattr(c0, "gossip_compress", "none").startswith("topk")
                and c0.gossip_impl != "none"):
            raise model_axis_conflict(
                "topk gossip compression (the payload indices address the "
                "full D axis)")
    if fuse_update_mix:
        if layout == "tree":
            raise ValueError(
                "fuse_update_mix needs the flat (n, D) buffer layout — the "
                "update+mix kernels tile one contiguous buffer; use "
                "layout='flat'")
        if n_shards > 1:
            raise ValueError(
                "fuse_update_mix is single-device: the sharded engine "
                "overlaps its halo with interior compute instead "
                "(core/sharded.py); use n_shards=1")
        if n_model_shards > 1:
            raise model_axis_conflict("fuse_update_mix (--fuse-update-mix)")
    spec = EngineSpec(configs=configs, layout=layout, n_shards=n_shards,
                      axis_name=axis_name, t_steps=t_steps,
                      force_run_axis=force_run_axis, delta=delta,
                      n_model_shards=n_model_shards, model_axis=model_axis,
                      fuse_update_mix=fuse_update_mix)
    if spec.has_run_axis or t_steps is not None:
        spec.plan()  # full lattice validation (raises on bad combinations)
    return spec


# ---------------------------------------------------------------------------
# Lowering dispatch: EngineSpec -> executor
# ---------------------------------------------------------------------------


def _dispatch(espec: EngineSpec, flat_spec, mesh) -> str:
    """'tree', 'flat', 'sweep', 'sharded' or 'sharded_sweep', exactly
    where the reference's dispatch picks them (repro/core/engine.py:
    555-569): a mesh (even of one shard) lowers the sharded engine, a run
    axis with it the sharded lattice."""
    if espec.layout == "tree":
        return "tree"
    if flat_spec is None:
        raise ValueError("flat layouts need a FlatSpec (flat.make_flat_spec)")
    if espec.is_sharded and mesh is None:
        raise ValueError("n_shards > 1 needs a device mesh (mesh=...)")
    if espec.is_model_sharded and mesh is None:
        raise ValueError("n_model_shards > 1 needs a 2-D device mesh "
                         "(launch.mesh.make_fed_mesh)")
    if espec.is_model_sharded:
        return "sharded"
    if espec.has_run_axis:
        return "sharded_sweep" if mesh is not None else "sweep"
    return "sharded" if mesh is not None else "flat"


def _lower_step(espec: EngineSpec, grad_fn: GradFn, lr_fn, device,
                flat_spec, mesh, gossip_fn, optimizer, delta_base,
                per_step_keys: bool = False, metrics_fn=None):
    """The one-iteration executor of a spec, after the reference's checks
    in the reference's order."""
    kind = _dispatch(espec, flat_spec, mesh)
    if kind in ("sweep", "sharded_sweep") and gossip_fn is not None:
        raise ValueError("gossip_fn overrides are single-run only")
    if kind in ("tree", "flat", "sharded") and per_step_keys:
        raise ValueError("per_step_keys needs a run axis (sweep lowering)")
    if kind == "sharded" and metrics_fn is not None:
        raise ValueError("metrics_fn is not supported by the single-run "
                         "sharded lowering")
    if delta_base is not None and espec.delta == "none":
        raise ValueError("delta_base was passed but the spec has "
                         "delta='none'")
    if espec.fuse_update_mix and kind not in ("flat", "sweep"):
        raise ValueError(
            "fuse_update_mix lowers on the flat / sweep engines only; the "
            f"'{kind}' lowering was selected (drop the mesh or the flag)")
    if per_step_keys:
        raise ValueError("per_step_keys (a (T, R) key array per round) is "
                         "not ported as a key table: pass a "
                         "repro_torch.core.draws.RoundDraws as the draws, "
                         "which re-keys every run at each of its server "
                         "rounds")
    if espec.is_model_sharded:
        raise NotImplementedError(
            "the 2-D ('agents', 'model') lowering (n_model_shards > 1) is "
            "not ported to repro_torch yet; see ROADMAP.md Queue A item 4 "
            "(the 2-D agents x model line)")
    device = torch.device(device)
    if kind == "tree":
        from repro_torch.core import feddec
        ops = feddec._tree_ops(espec.cfg, grad_fn, lr_fn, gossip_fn,
                               optimizer, device)
    elif kind == "flat":
        from repro_torch.core import flat as flat_lib
        ops = flat_lib._flat_ops(espec.cfg, flat_spec, grad_fn, lr_fn,
                                 gossip_fn, optimizer, device,
                                 delta_base=delta_base,
                                 fuse_update_mix=espec.fuse_update_mix)
    elif kind == "sweep":
        from repro_torch.core import sweep as sweep_lib
        ops = sweep_lib._sweep_ops(espec.plan(), flat_spec, grad_fn, lr_fn,
                                   optimizer, device,
                                   fuse_update_mix=espec.fuse_update_mix)
    elif kind == "sharded":
        # gossip_fn is not the sharded lowering's, as in the reference
        from repro_torch.core import sharded as sharded_lib
        ops = sharded_lib._shard_ops(espec.cfg, flat_spec, grad_fn, lr_fn,
                                     mesh, espec.axis_name, optimizer,
                                     device)
    else:
        from repro_torch.core import sharded as sharded_lib
        ops = sharded_lib._sweep_shard_ops(espec.plan(), flat_spec, grad_fn,
                                           lr_fn, mesh, espec.axis_name,
                                           optimizer, device)
    return build_step_body(ops)


def make_engine_step(espec: EngineSpec, grad_fn: GradFn, lr_fn, *, device,
                     flat_spec=None, mesh=None, gossip_fn=None,
                     optimizer=None, delta_base=None):
    """Lower an EngineSpec to its one-iteration executor
    (repro/core/engine.py:648-690): step(state, batch, draws) -> (state,
    metrics), the state donated (updated in place and returned).

    ``device`` is where the state lives (W^t and η are made there).
    ``delta_base`` is the (D,) base row of a ``delta != 'none'`` spec
    (zeros by default).  The reference's ``jit``, ``donate``, ``unroll``
    and ``block_d`` are not taken: the port's executors run eagerly, one
    op after another, always donate their input state, and its kernels
    choose their own tiles.
    """
    return _lower_step(espec, grad_fn, lr_fn, device, flat_spec, mesh,
                       gossip_fn, optimizer, delta_base)


def make_engine_round(espec: EngineSpec, grad_fn: GradFn, lr_fn, *, device,
                      flat_spec=None, mesh=None, gossip_fn=None,
                      optimizer=None, delta_base=None, metrics_fn=None,
                      per_step_keys: bool = False):
    """Lower an EngineSpec to its round executor (repro/core/engine.py:
    572-645): round_fn(state, batches, draws) runs one step per leading
    index of the batch leaves, metrics stacked to (H, ...).

    Dispatch: layout 'tree' → the tree engine; a run axis → the sweep
    lattice; a mesh → the sharded engine; both → the sharded lattice;
    else the flat engine.  ``metrics_fn(state)`` is merged into
    each step's metrics.  ``per_step_keys`` (the reference's (T, R) key
    table) is the draws object's business in the port: a lattice raises
    and names :class:`repro_torch.core.draws.RoundDraws`.
    """
    return make_loop_round(_lower_step(
        espec, grad_fn, lr_fn, device, flat_spec, mesh, gossip_fn,
        optimizer, delta_base, per_step_keys, metrics_fn), metrics_fn)


def shard_sweep_state(state, mesh, axis_name="agents"):
    """This rank's (R, n_local, D) block of a SweepFedState
    (repro/core/engine.py:1034-1040; core/sharded.py)."""
    from repro_torch.core import sharded as sharded_lib
    return sharded_lib.shard_sweep_state(state, mesh, axis_name)


def make_sharded_sweep_step(plan, spec, grad_fn: GradFn, lr_fn, mesh, *,
                            device, axis_name="agents", optimizer=None):
    """The sharded lattice's one-step executor (repro/core/engine.py:
    1062-1094; core/sharded.py:make_sharded_sweep_step)."""
    from repro_torch.core import sharded as sharded_lib
    return sharded_lib.make_sharded_sweep_step(
        plan, spec, grad_fn, lr_fn, mesh, device=device,
        axis_name=axis_name, optimizer=optimizer)


def make_sharded_sweep_round(plan, spec, grad_fn: GradFn, lr_fn, mesh, *,
                             device, axis_name="agents", optimizer=None,
                             metrics_fn=None, per_step_keys: bool = False):
    """The sharded lattice's round (repro/core/engine.py:1097-1145;
    core/sharded.py:make_sharded_sweep_round)."""
    from repro_torch.core import sharded as sharded_lib
    return sharded_lib.make_sharded_sweep_round(
        plan, spec, grad_fn, lr_fn, mesh, device=device,
        axis_name=axis_name, optimizer=optimizer, metrics_fn=metrics_fn,
        per_step_keys=per_step_keys)
