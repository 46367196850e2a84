"""Flat-state FedDec engine: Algorithm 1 on one contiguous (n_agents, D)
buffer (repro/core/flat.py).

The parameters of all agents live in one (n, D) tensor; each op of the
hot loop is one whole-buffer pass: the optimizer update, the gossip mix
W @ flat (or its fused form with the update, kernels #3/#4), and the
server's (n,)·(n, D) average.  With a codec (``gossip_compress``) the mix
runs on the compressed payload with an (n, D) error-feedback residual
(core/compress.py; the EF mix kernels #9/#11, or #14 on int8 × pallas).
A delta parameterization (``delta``, core/delta.py) runs the same
error-feedback exchange on each agent's encoded delta against a shared
base row.  The model sees a dict of tensors only at the gradient
boundary, as views into the buffer.

Layout contract with the reference: :class:`FlatSpec` orders the leaves
the way ``jax.tree.flatten`` orders a nested dict (sorted keys,
recursively), so the port's buffer equals the reference's column for
column and the two can be compared directly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import tensor_from_numpy
from repro_torch.core import compress as compress_lib
from repro_torch.core import delta as delta_lib
from repro_torch.core import engine
from repro_torch.core import gossip as gossip_lib
from repro_torch.core import server as server_lib
from repro_torch.core.feddec import FedDecConfig, FedState
from repro_torch.tree import build_tree, leaves, sorted_leaves

__all__ = ["FlatSpec", "FlatFedState", "make_flat_spec",
           "make_flat_spec_from_stacked", "init_flat_state",
           "params_from_numpy", "flat_state_from_numpy",
           "fedstate_from_numpy", "flatten_fedstate", "unflatten_fedstate",
           "grads_of", "make_flat_feddec_step", "make_flat_feddec_round"]

LrFn = Callable[[int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static ravel/unravel spec: dict of tensors ⇄ contiguous flat row.

    Attributes:
      paths: per-leaf key paths, in the reference's leaf order.
      shapes/dtypes: per-leaf shapes (no agent dim) and original dtypes.
      offsets/sizes: per-leaf [offset, offset+size) spans of the row.
      d: total flat length D.
      dtype: the buffer dtype.
    """

    paths: tuple
    shapes: tuple
    dtypes: tuple
    offsets: tuple
    sizes: tuple
    d: int
    dtype: torch.dtype

    def ravel(self, tree: dict) -> torch.Tensor:
        return torch.cat([leaf.to(self.dtype).reshape(-1)
                          for leaf in leaves(tree)])

    def views(self, row: torch.Tensor) -> list:
        """(D,) row → its leaves in order, as views into it (no copy)."""
        return [row[o:o + s].view(shape)
                for o, s, shape in zip(self.offsets, self.sizes, self.shapes)]

    def unravel(self, row: torch.Tensor) -> dict:
        """(D,) row → dict of views into it (no copy for the buffer dtype)."""
        return build_tree(self.paths, [
            v.to(dt) for v, dt in zip(self.views(row), self.dtypes)])

    def flatten(self, stacked, dtype=None) -> torch.Tensor:
        """A stacked tree (every leaf (rows, ...)) → a new (rows, D) buffer
        in ``dtype`` (default the buffer dtype)."""
        dtype = self.dtype if dtype is None else dtype
        return torch.cat([leaf.reshape(leaf.shape[0], -1).to(dtype)
                          for _, leaf in sorted_leaves(stacked)], dim=1)

    def unflatten(self, flat: torch.Tensor, cast: bool = True):
        """(rows, D) buffer → the stacked tree of per-leaf views
        ``flat[:, o:o+s].view((rows,) + shape)`` (no copy), cast to the
        leaves' own dtypes with ``cast``."""
        rows = flat.shape[0]
        views = [flat[:, o:o + s].view((rows,) + shape)
                 for o, s, shape in zip(self.offsets, self.sizes,
                                        self.shapes)]
        if cast:
            views = [v.to(dt) for v, dt in zip(views, self.dtypes)]
        return build_tree(self.paths, views)


def make_flat_spec(params_single: dict, dtype=None) -> FlatSpec:
    """Spec from one agent's parameters (any tensors with shape/dtype)."""
    return _spec_from_leaves(list(sorted_leaves(params_single)), dtype)


def make_flat_spec_from_stacked(stacked, dtype=None) -> FlatSpec:
    """Spec from a stacked tree (the leading agent dim of every leaf is
    not part of the row)."""
    return _spec_from_leaves([(path, leaf[0]) for path, leaf
                              in sorted_leaves(stacked)], dtype)


def _spec_from_leaves(pairs, dtype) -> FlatSpec:
    shapes = tuple(tuple(leaf.shape) for _, leaf in pairs)
    dtypes = tuple(leaf.dtype for _, leaf in pairs)
    if dtype is None:
        dtype = dtypes[0]
        for dt in dtypes[1:]:
            dtype = torch.promote_types(dtype, dt)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
    return FlatSpec(paths=tuple(p for p, _ in pairs), shapes=shapes,
                    dtypes=dtypes, offsets=offsets, sizes=sizes,
                    d=int(sum(sizes)), dtype=dtype)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """A reference tree of arrays (``jax.tree.map(np.asarray, params)``,
    or a decode-cache tree, whose layout is the port's too) → the port's
    dict of tensors: same key paths, shapes and dtypes (bfloat16
    included)."""
    return build_tree(*zip(*[
        (path, tensor_from_numpy(leaf, device))
        for path, leaf in sorted_leaves(tree)]))


# ---------------------------------------------------------------------------
# Flat training state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlatFedState:
    """The (n_agents, D) buffer, the step counter t (starts at 1), the
    optimizer buffers (momentum: an (n, D) f32 tensor; adamw: f32 (n, D)
    ``m`` and ``v`` and one int32 ``count``; sgd: ()) and the
    compressed-gossip EF residual (an (n, D) tensor, or () without a
    codec)."""

    flat: torch.Tensor
    step: int
    opt_state: Any = ()
    residual: Any = ()


def init_flat_state(spec: FlatSpec, params_single: dict, n_agents: int,
                    optimizer=None, compress: str = "none",
                    delta: str = "none") -> FlatFedState:
    """z_i^1 = z^1 ∀i (Alg. 1 line 1), directly in the flat layout.

    ``compress != 'none'`` adds the zero (n, D) error-feedback residual
    that the compressed-gossip step carries (core/compress.py);
    ``delta != 'none'`` carries the same residual for the delta-encoded
    exchange (core/delta.py; repro/core/flat.py:179-195)."""
    row = spec.ravel(params_single)
    flat = row.unsqueeze(0).repeat(n_agents, 1)
    opt_state = optimizer.init(flat) if optimizer is not None else ()
    needs_res = (compress_lib.parse_compress(compress) is not None
                 or delta_lib.parse_delta(delta).kind != "none")
    residual = torch.zeros((n_agents, spec.d), dtype=spec.dtype,
                           device=flat.device) if needs_res else ()
    return FlatFedState(flat=flat, step=1, opt_state=opt_state,
                        residual=residual)


def _no_buffer(value) -> bool:
    """() is the 'no buffer' sentinel of opt_state and residual."""
    return isinstance(value, tuple) and value == ()


def flat_state_from_numpy(flat, step, opt_state=(), device="cpu",
                          residual=()):
    """A reference FlatFedState's arrays (its residual too) → the port's
    FlatFedState."""
    def tensor(a):
        if _no_buffer(a):
            return ()
        if isinstance(a, dict):   # adamw's {'m', 'v', 'count'}
            return params_from_numpy(a, device)
        return torch.as_tensor(np.asarray(a), device=device)
    return FlatFedState(flat=tensor(flat), step=int(np.asarray(step)),
                        opt_state=tensor(opt_state),
                        residual=tensor(residual))


def fedstate_from_numpy(params, step, opt_state=(), device="cpu",
                        residual=()) -> FedState:
    """A reference FedState's arrays (``jax.tree.map(np.asarray, ...)``;
    adamw's {'m', 'v', 'count'} too) → the port's FedState."""
    def tree(value):
        return () if _no_buffer(value) else params_from_numpy(value, device)
    return FedState(params=tree(params), step=int(np.asarray(step)),
                    opt_state=tree(opt_state), residual=tree(residual))


def _is_adamw_state(opt_state) -> bool:
    return isinstance(opt_state, dict) and set(opt_state) == {"m", "v",
                                                              "count"}


def _moment_dtype(tree) -> torch.dtype:
    dtypes = [leaf.dtype for leaf in leaves(tree)]
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


def _flatten_opt_state(spec: FlatSpec, opt_state):
    """Tree-engine opt state → flat buffers (repro/core/flat.py:183-210).

    Moment slots keep their own (f32) dtype, as ``init_flat_state``'s
    ``optimizer.init(flat)`` makes them; adamw's per-agent count, equal
    across agents by construction, becomes the flat engine's one scalar.
    """
    if _no_buffer(opt_state):
        return ()
    if tuple(p for p, _ in sorted_leaves(opt_state)) == spec.paths:
        return spec.flatten(opt_state, _moment_dtype(opt_state))
    if _is_adamw_state(opt_state):
        return {"m": spec.flatten(opt_state["m"],
                                  _moment_dtype(opt_state["m"])),
                "v": spec.flatten(opt_state["v"],
                                  _moment_dtype(opt_state["v"])),
                "count": opt_state["count"][0].clone()}
    raise ValueError(
        "cannot flatten this optimizer state layout; re-init with "
        "init_flat_state(spec, params_single, n, optimizer=...) instead")


def _unflatten_opt_state(spec: FlatSpec, opt_state, n_agents: int):
    if _no_buffer(opt_state):
        return ()
    if _is_adamw_state(opt_state):
        return {"m": spec.unflatten(opt_state["m"], cast=False),
                "v": spec.unflatten(opt_state["v"], cast=False),
                "count": opt_state["count"].reshape(1).repeat(n_agents)}
    return spec.unflatten(opt_state, cast=False)


def flatten_fedstate(spec: FlatSpec, state: FedState) -> FlatFedState:
    """Tree-engine FedState → FlatFedState: new (n, D) buffers."""
    residual = () if _no_buffer(state.residual) \
        else spec.flatten(state.residual)
    return FlatFedState(flat=spec.flatten(state.params), step=state.step,
                        opt_state=_flatten_opt_state(spec, state.opt_state),
                        residual=residual)


def unflatten_fedstate(spec: FlatSpec, fstate: FlatFedState) -> FedState:
    """FlatFedState → tree-engine FedState, every leaf a view into the
    flat buffers (repro/core/flat.py:254-265); adamw's scalar count is
    repeated to one per agent."""
    n = fstate.flat.shape[0]
    residual = () if _no_buffer(fstate.residual) \
        else spec.unflatten(fstate.residual, cast=False)
    return FedState(params=spec.unflatten(fstate.flat), step=fstate.step,
                    opt_state=_unflatten_opt_state(spec, fstate.opt_state, n),
                    residual=residual)


# ---------------------------------------------------------------------------
# Engine ops
# ---------------------------------------------------------------------------


def _fuse_kind(cfg: FedDecConfig, optimizer, custom_gossip: bool):
    """The optimizer kind the fused update+mix kernels replicate, or None
    when this configuration keeps the unfused two-op path.

    Fusable: sgd (optimizer=None or kind 'sgd') and momentum, on the
    dense/pallas/sparse mixes.  A custom optimizer or gossip_fn, impl
    'none', or a sparse graph outside the ELL range falls back.
    """
    if custom_gossip or cfg.gossip_impl not in ("dense", "pallas", "sparse"):
        return None
    kind = "sgd" if optimizer is None else getattr(optimizer, "kind",
                                                   "custom")
    if kind not in ("sgd", "momentum"):
        return None
    if cfg.gossip_impl == "sparse":
        graph = cfg.mixing.graph
        max_deg = int(graph.degrees.max()) if graph.n else 0
        if not 0 < max_deg <= gossip_lib.ELL_MAX_DEG:
            return None
    return kind


def make_fused_op(kind: str, agent_grads, optimizer, dense_mix,
                  make_sparse_mix=None):
    """The uncompressed fused lines-5–6 op of the flat and sweep engines:
    one update+mix kernel pass for a fusable optimizer ``kind``; the
    residual (()) passes through.

    ``dense_mix`` is the dense kernel's wrapper (kernels #3/#7);
    ``make_sparse_mix(beta=, nesterov=)`` builds the ELL form (#4/#8) and
    replaces it on the sparse mix.
    """
    hyper = optimizer.hyperparams() if kind == "momentum" else {}
    beta = hyper.get("beta")
    nesterov = bool(hyper.get("nesterov", False))
    if make_sparse_mix is not None:
        fused_mix = make_sparse_mix(beta=beta, nesterov=nesterov)
    else:
        def fused_mix(w, x, g, eta, m=None):
            return dense_mix(w, x, g, eta, m, beta=beta, nesterov=nesterov)

    def fused(w, state, batch, eta, residual, draws, t):
        losses, g_flat = agent_grads(state, batch)
        if kind == "sgd":
            return losses, fused_mix(w, state.flat, g_flat, eta), \
                state.opt_state, residual
        y, new_m = fused_mix(w, state.flat, g_flat, eta, state.opt_state)
        return losses, y, new_m, residual

    return fused


def make_fused_ef_op(local_update, ef_gossip):
    """The compressed fused lines-5–6 op of the flat and sweep engines: the
    update in plain torch, then ``ef_gossip`` (one EF mix pass,
    compress.make_fused_ef_gossip) on its result
    (repro/core/flat.py:332-348, repro/core/sweep.py:388-410)."""
    def fused(w, state, batch, eta, residual, draws, t):
        losses, x_half, new_opt = local_update(state, batch, eta)
        y, new_res = ef_gossip(w, x_half, residual, draws, t)
        return losses, y, new_opt, new_res

    return fused


def _make_fused_flat_op(cfg: FedDecConfig, agent_grads, local_update,
                        optimizer, compressor, custom_gossip: bool):
    """The flat engine's fused op; None when the configuration is not
    eligible (the caller keeps the unfused body).

    Uncompressed: one update+mix pass (kernels #3/#4), the post-update
    iterate never in memory.  With a codec: :func:`make_fused_ef_op` with
    kernel #9 on the dense and pallas mixes, #11 on the sparse one.
    """
    kind = _fuse_kind(cfg, optimizer, custom_gossip)
    if kind is None:
        return None
    from repro_torch.kernels import ops as kernel_ops
    if compressor is not None:
        ef_kernel = kernel_ops.make_sparse_ef_mix(cfg.mixing.graph) \
            if cfg.gossip_impl == "sparse" else kernel_ops.ef_mix
        ef_gossip = compress_lib.make_fused_ef_gossip(compressor, ef_kernel)
        return make_fused_ef_op(local_update, ef_gossip)
    sparse = None
    if cfg.gossip_impl == "sparse":
        sparse = functools.partial(kernel_ops.make_sparse_update_mix,
                                   cfg.mixing.graph)
    return make_fused_op(kind, agent_grads, optimizer, kernel_ops.update_mix,
                         sparse)


def grads_of(spec: FlatSpec, grad_fn: engine.GradFn, flat: torch.Tensor,
             batch: dict):
    """Line 4: every agent's loss and gradient over the rows of a
    (rows, D) buffer, in ONE call of ``torch.func.vmap(grad_fn)``.

    The flat engine passes its (n, D) buffer; the sweep engine the
    (R·n, D) view of its lattice, treating (R, n) as one flattened agent
    axis as the reference does (repro/core/flat.py:403-408,
    repro/core/sweep.py:335-344).  The parameters are the per-leaf views
    ``flat[:, o:o+s].view((rows,) + shape)`` (nothing copies them); batch
    leaves lead with the rows dim.  The gradient tree comes back whole,
    (rows, ...) per leaf, and is written into one (rows, D) buffer in
    FlatSpec order.  The losses keep the loss's dtype.  The backward runs
    on the calling thread, so that the step's peak memory does not depend
    on how autograd's device threads interleave with it.
    """
    rows = flat.shape[0]
    params = spec.unflatten(flat, cast=False)
    # the backward on this thread: with autograd's device threads freeing
    # beside the caller, identical steps peaked whole buffers apart
    with torch.autograd.set_multithreading_enabled(False):
        out = torch.func.vmap(grad_fn)(params, batch)
    if not (isinstance(out, tuple) and len(out) == 2):
        raise TypeError("grad_fn must return (loss, grads), an "
                        "engine.GradFn; wrap a loss as "
                        "engine.value_and_grad(loss)")
    losses, grads = out
    g_flat = torch.cat([g.reshape(rows, -1)
                        for _, g in sorted_leaves(grads)], dim=1)
    return losses, g_flat


def _delta_codec(cfg: FedDecConfig, spec: FlatSpec, delta_base, device):
    """The delta codec over the base row (zeros by default), or None
    (repro/core/flat.py:385-395)."""
    if delta_lib.parse_delta(cfg.delta).kind == "none":
        return None
    if delta_base is None:
        base = torch.zeros(spec.d, dtype=spec.dtype, device=device)
    else:
        base = torch.as_tensor(delta_base, dtype=spec.dtype,
                               device=device).reshape(-1)
    if base.shape[0] != spec.d:
        raise ValueError(f"delta_base has D={base.shape[0]}, flat spec "
                         f"has D={spec.d}")
    return delta_lib.make_delta_codec(cfg.delta, base)


def _flat_ops(cfg: FedDecConfig, spec: FlatSpec, grad_fn: engine.GradFn,
              lr_fn: LrFn, gossip_fn, optimizer, device, delta_base=None,
              fuse_update_mix: bool = False,
              agent_grads=None) -> engine.EngineOps:
    """The flat engine's vtable for the shared Algorithm-1 body.
    ``agent_grads(state, batch) -> (losses, g)``, where given, replaces
    line 4's one vmapped pass over the buffer (the 2-D sharded engine
    gathers its column blocks first)."""
    custom_gossip = gossip_fn is not None
    if gossip_fn is None:
        gossip_fn = engine.resolve_gossip(cfg, "flat")
    # whole-buffer compressed exchange with error feedback; nothing is
    # exchanged under impl 'none', so no codec and the residual passes
    # through.  int8 × 'pallas' mixes straight from the int8 payload (#14)
    compressor = compress_lib.parse_compress(cfg.gossip_compress) \
        if cfg.gossip_impl != "none" else None
    # a delta parameterization: the wire carries each agent's encoded
    # delta against the base row, through the same EF exchange (and the
    # same kernels, #1/#2 unfused, #9/#11 fused); 'full' is lossless
    if compressor is None and cfg.gossip_impl != "none":
        compressor = _delta_codec(cfg, spec, delta_base, device)
    ef_gossip = None
    if compressor is not None:
        ef_gossip = compress_lib.make_flat_ef_gossip(
            compressor, gossip_fn, cfg.n_agents,
            fused_int8_pallas=cfg.gossip_impl == "pallas"
            and not custom_gossip)

    if agent_grads is None:
        def agent_grads(state: FlatFedState, batch: dict):
            return grads_of(spec, grad_fn, state.flat, batch)

    def local_update(state: FlatFedState, batch: dict, eta):
        losses, g_flat = agent_grads(state, batch)
        if optimizer is None:  # plain SGD: η·g scaled in place, one new buffer
            return losses, state.flat - g_flat.mul_(eta.to(spec.dtype)), \
                state.opt_state
        x_half, new_opt = optimizer.update(state.flat, g_flat,
                                           state.opt_state, eta)
        return losses, x_half, new_opt

    fused_update_gossip = None
    if fuse_update_mix:
        fused_update_gossip = _make_fused_flat_op(
            cfg, agent_grads, local_update, optimizer, compressor,
            custom_gossip)

    def server(draws, t, x_next):
        if not cfg.server_enabled or (t + 1) % cfg.h:
            return x_next
        return server_lib.server_round_flat(draws, t, x_next, cfg.k)

    def finish(state, z_next, new_opt, new_res, t, losses, eta):
        # The input state is donated, as the reference's executors donate
        # it (donate=True): updated in place, so the previous (n, D)
        # buffers are freed now even while a caller still holds the object.
        state.flat, state.step, state.opt_state = z_next, t + 1, new_opt
        state.residual = new_res
        return state, {"loss": losses.mean(), "eta": eta.reshape(())}

    return engine.EngineOps(
        get_step=lambda s: s.step,
        eta_fn=lr_fn,
        sample_w=cfg.mixing.make_sampler(device),
        local_update=local_update,
        gossip=gossip_fn,
        get_residual=lambda s: s.residual,
        server=server,
        finish=finish,
        ef_gossip=ef_gossip,
        fused_update_gossip=fused_update_gossip)


def make_flat_feddec_step(cfg: FedDecConfig, spec: FlatSpec,
                          grad_fn: engine.GradFn, lr_fn: LrFn, *, device,
                          gossip_fn=None, optimizer=None,
                          fuse_update_mix: bool = False, delta_base=None):
    """One-iteration executor: step(state, batch, draws) ->
    (FlatFedState, {'loss', 'eta'}); batch leaves have a leading agent
    dim.  ``grad_fn`` is one agent's line 4 (engine.GradFn), called once
    over all n agents per step.  ``lr_fn(t)`` returns η_t as a (1,) f32
    tensor on ``device``.  ``delta_base`` is the (D,) base row of a
    ``cfg.delta != 'none'`` run (zeros by default).  The state passed in
    is donated: updated in place and returned.  A shim over
    :func:`engine.make_engine_step`."""
    espec = engine.parse_engine_spec(cfg, layout="flat",
                                     fuse_update_mix=fuse_update_mix)
    return engine.make_engine_step(espec, grad_fn, lr_fn, device=device,
                                   flat_spec=spec, gossip_fn=gossip_fn,
                                   optimizer=optimizer,
                                   delta_base=delta_base)


def make_flat_feddec_round(cfg: FedDecConfig, spec: FlatSpec,
                           grad_fn: engine.GradFn, lr_fn: LrFn, *, device,
                           gossip_fn=None, optimizer=None,
                           fuse_update_mix: bool = False, metrics_fn=None,
                           delta_base=None):
    """The H-step round: round_fn(state, batches, draws) with every batch
    leaf stacked on a leading step dim; metrics stack to (H,).  The
    server round fires on the step with (t+1) % H == 0.  ``metrics_fn``
    (state -> dict) is evaluated after every step and merged into its
    metrics.  The state passed in is donated, as in
    :func:`make_flat_feddec_step`.  A shim over
    :func:`engine.make_engine_round`."""
    espec = engine.parse_engine_spec(cfg, layout="flat",
                                     fuse_update_mix=fuse_update_mix)
    return engine.make_engine_round(espec, grad_fn, lr_fn, device=device,
                                    flat_spec=spec, gossip_fn=gossip_fn,
                                    optimizer=optimizer,
                                    delta_base=delta_base,
                                    metrics_fn=metrics_fn)
