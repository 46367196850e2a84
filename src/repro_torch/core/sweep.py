"""Batched sweep engine: R independent FedDec runs on one (R, n, D) buffer
(repro/core/sweep.py).

The paper's results are sweeps over seeds, the server period H and the
graph.  This module stacks the R runs of such a lattice into one
(R, n_agents, D) buffer and advances them together: every Algorithm-1
line is one whole-lattice op, and the gossip mix (or the fused
update+mix) is one kernel launch for all R runs (kernels #5–#8).

  * Per-run randomness: the draws object gives (R, n, n) link uniforms
    and (R, K) participants, and receives ``t`` as the (R,) array of
    per-run step counters (core/draws.py:SweepDraws; the tests replay the
    reference's per-run keys through the same methods).
  * Per-run mixing: fixed Ws are stacked host-side; runs with link
    failures resample Metropolis weights every step from their own
    adjacency; FedAvg members (gossip_impl 'none') mix with W = I, which
    every batched mix reduces to ``y = x`` exactly.
  * Per-run H: run r's server round fires on (t+1) % h_r == 0.
  * Per-run budgets ``t_steps``: a run past its budget keeps its flat,
    step, opt_state and residual frozen bit for bit while the rest
    finish.
  * Compressed gossip (a ``gossip_compress`` shared by the lattice): an
    (R, n, D) error-feedback residual, the codec row by row over every
    run, the int8 noise from ``draws.codec_noise`` (per run on the seed
    axis); the unfused EF gossip mixes the decoded s with the lattice's
    mix (#5, #6 or the dense product), the fused EF op runs kernel #10
    (#12 on sparse).  FedAvg members bypass the codec: their y is x_half
    and their residual is kept (repro/core/sweep.py:322-410).

The local update treats (R, n) as one flattened agent axis of R·n rows:
one batched ``flat.grads_of`` call over the (R·n, D) view.  The
executors donate their input state, as the flat ones do.  The
reference's ``per_step_keys`` is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine
from repro_torch.core import flat as flat_lib
from repro_torch.core import gossip as gossip_lib
from repro_torch.core import server as server_lib
from repro_torch.core.flat import FlatFedState, FlatSpec, LrFn
from repro_torch.core.mixing import metropolis_from_uniforms

__all__ = ["SweepPlan", "SweepFedState", "make_sweep_plan",
           "init_sweep_state", "stack_flat_states", "slice_run",
           "resolve_sweep_gossip", "make_sweep_w_sampler",
           "grads_of_lattice", "make_sweep_feddec_step",
           "make_sweep_feddec_round"]


@dataclasses.dataclass(frozen=True, eq=False)
class SweepPlan:
    """Static description of an R-run lattice (host-side, closed over).

    Built by :func:`make_sweep_plan` from one FedDecConfig per run.  The
    axes that may vary per run: topology / mixing scheme / p_fail (stacked
    into ``w_fixed`` / ``adjacency``), H (``h``), gossip_impl 'none'
    (FedAvg members, ``none_mask``) and the step budget ``t_steps``.
    Shared across the lattice (validated): n_agents, K, server_enabled,
    gossip_compress, the mixing dtype (``w_dtype``) and the non-'none'
    gossip impl.
    """

    configs: tuple
    n_agents: int
    k: int
    server_enabled: bool
    gossip_impl: str          # the shared non-'none' impl ('none' if all)
    gossip_compress: str      # the shared codec spec ('none': no codec)
    h: np.ndarray             # (R,) int32 per-run server period
    w_fixed: np.ndarray       # (R, n, n) f64 fixed Ws (I for 'none' runs)
    adjacency: np.ndarray     # (R, n, n) bool (zeros for fixed/'none' runs)
    p_fail: np.ndarray        # (R,) f32
    stochastic: np.ndarray    # (R,) bool: runs that resample W per step
    none_mask: np.ndarray     # (R,) bool: runs mixing with W = I
    t_steps: np.ndarray | None = None   # (R,) int32 per-run step budgets
    w_dtype: torch.dtype = torch.float32  # the dtype of every run's W^t

    @property
    def r_runs(self) -> int:
        return len(self.configs)

    @property
    def graphs(self) -> tuple:
        """Per-run mixing-support graphs ('none' runs: their own graph)."""
        return tuple(c.mixing.graph for c in self.configs)


def make_sweep_plan(configs, t_steps=None) -> SweepPlan:
    """Validate a per-run config lattice and stack its varying axes.

    Args:
      configs: one FedDecConfig per run (R total).  ``gossip_impl`` may mix
        'none' (FedAvg) with exactly one other impl; n_agents, k,
        server_enabled, gossip_compress and the mixing dtype must be
        shared.
      t_steps: optional per-run step budgets (R ints).  Runs whose budget is
        below the number of steps run finish early and are frozen.
    """
    configs = tuple(configs)
    if not configs:
        raise ValueError("sweep needs at least one run config")
    n = configs[0].n_agents
    k = configs[0].k
    server_enabled = configs[0].server_enabled
    compress = configs[0].gossip_compress
    w_dtype = configs[0].mixing.dtype
    for c in configs:
        if c.n_agents != n:
            raise ValueError(f"n_agents must be shared across the lattice: "
                             f"{c.n_agents} != {n}")
        if c.k != k:
            raise ValueError(f"K must be shared across the lattice: "
                             f"{c.k} != {k}")
        if c.server_enabled != server_enabled:
            raise ValueError("server_enabled must be shared across the "
                             "lattice")
        if c.gossip_compress != compress:
            raise ValueError("gossip_compress must be shared across the "
                             "lattice")
        if c.mixing.dtype != w_dtype:
            raise ValueError("mixing dtype must be shared across the "
                             "lattice")
    impls = {c.gossip_impl for c in configs} - {"none"}
    if len(impls) > 1:
        raise ValueError(f"a lattice may mix 'none' (FedAvg) with at most "
                         f"one other gossip_impl, got {sorted(impls)}")
    impl = engine.check_gossip_impl(impls.pop()) if impls else "none"

    r = len(configs)
    h = np.asarray([c.h for c in configs], dtype=np.int32)
    none_mask = np.asarray([c.gossip_impl == "none" for c in configs])
    stochastic = np.asarray([c.mixing.p_fail > 0 and not nm
                             for c, nm in zip(configs, none_mask)])
    p_fail = np.asarray([c.mixing.p_fail for c in configs], dtype=np.float32)
    w_fixed = np.zeros((r, n, n), dtype=np.float64)
    adjacency = np.zeros((r, n, n), dtype=bool)
    for i, c in enumerate(configs):
        if none_mask[i]:
            w_fixed[i] = np.eye(n)
        elif stochastic[i]:
            adjacency[i] = c.mixing.graph.adjacency
        else:
            w_fixed[i] = c.mixing.fixed_w
    if t_steps is not None:
        t_steps = np.asarray(t_steps, dtype=np.int32)
        if t_steps.shape != (r,):
            raise ValueError(f"t_steps must be one budget per run, got "
                             f"shape {t_steps.shape} for {r} runs")
    return SweepPlan(configs=configs, n_agents=n, k=k,
                     server_enabled=server_enabled, gossip_impl=impl,
                     gossip_compress=compress, h=h, w_fixed=w_fixed,
                     adjacency=adjacency, p_fail=p_fail,
                     stochastic=stochastic, none_mask=none_mask,
                     t_steps=t_steps, w_dtype=w_dtype)


# ---------------------------------------------------------------------------
# Batched state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepFedState:
    """The lattice's carried state: run r's slice is that run's
    FlatFedState (``flat[r, i]`` is run r's x_i)."""

    flat: torch.Tensor   # (R, n_agents, D)
    step: np.ndarray     # (R,) int64 per-run t (each starts at 1)
    opt_state: Any = ()  # (R, n, D) f32 momentum, or () for sgd
    residual: Any = ()   # (R, n, D) compressed-gossip EF residual, or ()


def _compressor(plan: SweepPlan):
    """The lattice's codec, or None: nothing is exchanged (so nothing is
    compressed) when every run is a FedAvg member."""
    if plan.gossip_impl == "none":
        return None
    return compress_lib.parse_compress(plan.gossip_compress)


def init_sweep_state(plan: SweepPlan, spec: FlatSpec, params_single: dict,
                     optimizer=None) -> SweepFedState:
    """z_i^1 = z^1 for every agent of every run, in the batched layout;
    a zero (R, n, D) residual under a codec."""
    row = spec.ravel(params_single)
    flat = row[None, None].repeat(plan.r_runs, plan.n_agents, 1)
    opt_state = optimizer.init(flat) if optimizer is not None else ()
    residual = () if _compressor(plan) is None else torch.zeros_like(flat)
    return SweepFedState(flat=flat, step=np.ones(plan.r_runs, np.int64),
                         opt_state=opt_state, residual=residual)


def _stack(buffers):
    return () if isinstance(buffers[0], tuple) else torch.stack(buffers)


def stack_flat_states(states) -> SweepFedState:
    """Stack per-run FlatFedStates (e.g. mid-training) into a lattice."""
    return SweepFedState(
        flat=torch.stack([s.flat for s in states]),
        step=np.asarray([s.step for s in states], dtype=np.int64),
        opt_state=_stack([s.opt_state for s in states]),
        residual=_stack([s.residual for s in states]))


def slice_run(state: SweepFedState, r: int) -> FlatFedState:
    """Run r's slice as a single-run FlatFedState (views, no copy)."""
    def take(buffer):
        return () if isinstance(buffer, tuple) else buffer[r]
    return FlatFedState(flat=state.flat[r], step=int(state.step[r]),
                        opt_state=take(state.opt_state),
                        residual=take(state.residual))


# ---------------------------------------------------------------------------
# Batched mixing-matrix sampling and gossip dispatch
# ---------------------------------------------------------------------------


def make_sweep_w_sampler(plan: SweepPlan, device):
    """sample(draws, t) -> (R, n, n) per-run W^t in ``plan.w_dtype`` on
    ``device``.

    Fixed-W runs take the precomputed stack; stochastic runs resample
    Metropolis weights on their own surviving subgraph, every run of the
    lattice in one call (repro/core/sweep.py:237-259).
    """
    w_fixed = torch.as_tensor(plan.w_fixed, dtype=plan.w_dtype,
                              device=device)
    if not plan.stochastic.any():
        return lambda draws, t: w_fixed
    adj = torch.as_tensor(plan.adjacency, device=device)
    p_fail = torch.as_tensor(plan.p_fail, device=device)[:, None, None]
    stoch = torch.as_tensor(plan.stochastic, device=device)[:, None, None]

    def sample(draws, t) -> torch.Tensor:
        u = draws.link_uniforms(t, plan.n_agents).to(device)
        return torch.where(stoch, metropolis_from_uniforms(
            u, adj, p_fail, plan.w_dtype), w_fixed)

    return sample


def resolve_sweep_gossip(plan: SweepPlan):
    """gossip_impl → the whole-lattice (w (R,n,n), x (R,n,D)) mix: the
    'sweep' layout of :func:`repro_torch.core.engine.resolve_gossip`."""
    return engine.resolve_gossip(plan, "sweep")


# ---------------------------------------------------------------------------
# The batched Algorithm-1 step body
# ---------------------------------------------------------------------------


def _sweep_fuse_kind(plan: SweepPlan, optimizer):
    """Batched mirror of flat._fuse_kind: the optimizer kind the fused
    update+mix kernels (#7/#8; under a codec the EF mix #10/#12 after the
    update) replicate for this lattice, or None to keep the unfused path
    (a custom optimizer, an all-FedAvg lattice, or a sparse lattice
    outside the stacked-ELL range)."""
    if plan.gossip_impl not in ("dense", "pallas", "sparse"):
        return None
    kind = "sgd" if optimizer is None else getattr(optimizer, "kind",
                                                   "custom")
    if kind not in ("sgd", "momentum"):
        return None
    if plan.gossip_impl == "sparse":
        max_deg = gossip_lib.lattice_max_degree(plan.graphs)
        if not 0 < max_deg <= gossip_lib.ELL_MAX_DEG:
            return None
    return kind


def grads_of_lattice(spec: FlatSpec, grad_fn: engine.GradFn,
                     flat: torch.Tensor, batch: dict):
    """Line 4 of every run: one batched ``flat.grads_of`` call over the
    (R·n, D) view of the (R, n, D) lattice, batch leaves (R, n, ...)
    flattened alike (repro/core/sweep.py:335-344).  Returns the (R, n)
    losses and the (R, n, D) gradient."""
    r_runs, n = flat.shape[:2]
    batch_rn = {k: v.reshape((r_runs * n,) + v.shape[2:])
                for k, v in batch.items()}
    losses, g = flat_lib.grads_of(spec, grad_fn,
                                  flat.view(r_runs * n, spec.d), batch_rn)
    return losses.view(r_runs, n), g.view(r_runs, n, spec.d)


def _sweep_ops(plan: SweepPlan, spec: FlatSpec, grad_fn: engine.GradFn,
               lr_fn: LrFn, optimizer, device,
               fuse_update_mix: bool = False) -> engine.EngineOps:
    """The lattice engine's vtable: every Algorithm-1 line as one
    whole-lattice op.  ``lr_fn`` receives the (R,) per-run step counters
    and returns one η or R of them."""
    r_runs, n = plan.r_runs, plan.n_agents
    gossip_fn = resolve_sweep_gossip(plan)
    compressor = _compressor(plan)
    fedavg = np.flatnonzero(plan.none_mask)

    def bypass_codec(ef_gossip):
        """FedAvg members of a compressed lattice exchange nothing: their y
        is x_half and their residual is kept (repro/core/sweep.py:324-328).
        W = I does not make the EF form exact, since s + (p − s) need not
        round to p, so the mixed rows are put back."""
        if not len(fedavg):
            return ef_gossip

        def gossip(w, x_half, residual, draws, t):
            y, new_res = ef_gossip(w, x_half, residual, draws, t)
            for r in fedavg:
                y[r].copy_(x_half[r])
                new_res[r].copy_(residual[r])
            return y, new_res

        return gossip

    def agent_grads(state: SweepFedState, batch: dict):
        return grads_of_lattice(spec, grad_fn, state.flat, batch)

    def local_update(state: SweepFedState, batch: dict, eta):
        # lines 4–5; η broadcast as (R, 1, 1)
        losses, g3 = agent_grads(state, batch)
        eta3 = eta.reshape(r_runs, 1, 1)
        if optimizer is None:  # plain SGD: η·g scaled in place
            return losses, state.flat - g3.mul_(eta3.to(spec.dtype)), \
                state.opt_state
        x_half, new_opt = optimizer.update(state.flat, g3, state.opt_state,
                                           eta3)
        return losses, x_half, new_opt

    # line 6 on the compressed payload: the decoded s through the lattice's
    # mix, then the diagonal term (repro/core/sweep.py:357-374)
    ef_gossip = None
    if compressor is not None:
        ef_gossip = bypass_codec(compress_lib.make_flat_ef_gossip(
            compressor, gossip_fn, n))

    fused_update_gossip = None
    kind = _sweep_fuse_kind(plan, optimizer) if fuse_update_mix else None
    if kind is not None:
        from repro_torch.kernels import ops as kernel_ops
        sparse = plan.gossip_impl == "sparse"
        if compressor is not None:
            # the update and the encode, then one pass of #10 (#12 sparse)
            ef_kernel = kernel_ops.make_sparse_ef_mix_batched(plan.graphs) \
                if sparse else kernel_ops.ef_mix_batched
            fused_update_gossip = flat_lib.make_fused_ef_op(
                local_update, bypass_codec(compress_lib.make_fused_ef_gossip(
                    compressor, ef_kernel)))
        else:
            fused_update_gossip = flat_lib.make_fused_op(
                kind, agent_grads, optimizer, kernel_ops.update_mix_batched,
                functools.partial(kernel_ops.make_sparse_update_mix_batched,
                                  plan.graphs) if sparse else None)

    def server(draws, t, x_next):
        # lines 7–12: per-run periodic server round ((t+1) % h_r == 0)
        if not plan.server_enabled:
            return x_next
        return server_lib.server_round_sweep(draws, t, x_next, plan.k,
                                             (t + 1) % plan.h == 0)

    def finish(state, z_next, new_opt, new_res, t, losses, eta):
        metrics = {"loss": losses.mean(dim=1), "eta": eta}
        active = np.ones(r_runs, dtype=bool)
        if plan.t_steps is not None:
            # runs past their budget keep their state bit for bit
            active = t <= plan.t_steps
            for r in np.flatnonzero(~active):
                z_next[r].copy_(state.flat[r])
                for new, old in ((new_opt, state.opt_state),
                                 (new_res, state.residual)):
                    if not isinstance(new, tuple):
                        new[r].copy_(old[r])
            metrics["active"] = torch.as_tensor(active)
        # donated, as in the flat engine: the old buffers go now
        state.flat, state.opt_state = z_next, new_opt
        state.residual = new_res
        state.step = np.where(active, t + 1, t)
        return state, metrics

    return engine.EngineOps(
        get_step=lambda s: s.step,
        eta_fn=lambda t: torch.as_tensor(lr_fn(t)).reshape(-1).expand(
            r_runs),
        sample_w=make_sweep_w_sampler(plan, device),
        local_update=local_update,
        gossip=gossip_fn,
        get_residual=lambda s: s.residual,
        server=server,
        finish=finish,
        ef_gossip=ef_gossip,
        fused_update_gossip=fused_update_gossip)


def make_sweep_feddec_step(plan: SweepPlan, spec: FlatSpec,
                           grad_fn: engine.GradFn, lr_fn: LrFn, *, device,
                           optimizer=None,
                           fuse_update_mix: bool = False):
    """One-iteration lattice executor: step(state, batch, draws) advances
    all R runs by one Algorithm-1 step.  ``batch`` leaves are (R, n, ...);
    ``draws`` gives the per-run engine draws; ``grad_fn`` (one agent's
    line 4, engine.GradFn) is called once over all R·n agents a step.
    Metrics: per-run ``loss`` and ``eta`` (R,), and ``active`` (R,) when
    the plan has budgets.  The state passed in is donated: updated in
    place and returned."""
    return engine.build_step_body(
        _sweep_ops(plan, spec, grad_fn, lr_fn, optimizer, device,
                   fuse_update_mix=fuse_update_mix))


def make_sweep_feddec_round(plan: SweepPlan, spec: FlatSpec,
                            grad_fn: engine.GradFn, lr_fn: LrFn, *, device,
                            optimizer=None, fuse_update_mix: bool = False,
                            per_step_keys: bool = False):
    """The lattice round: T steps × R runs per call, with every batch
    leaf (T, R, n, ...) and metrics stacked to (T, R).  With
    ``plan.t_steps`` set, runs past their budget are frozen while the
    others continue.  The state passed in is donated."""
    if per_step_keys:
        raise ValueError("per_step_keys (a (T, R) key array per round) is "
                         "not ported to repro_torch yet; the port's draws "
                         "object keys every step itself")
    return engine.make_loop_round(make_sweep_feddec_step(
        plan, spec, grad_fn, lr_fn, device=device, optimizer=optimizer,
        fuse_update_mix=fuse_update_mix))
