"""The shared Algorithm-1 step body and the gossip dispatcher
(repro/core/engine.py, for the flat single-device layout).

  * :class:`EngineOps` + :func:`build_step_body` — the one step order:
    η_t → sample W^t (line 3) → local update (lines 4–5) → gossip (line 6,
    compressed with error feedback when a codec is configured) → periodic
    server round (lines 7–12) → carry rebuild.  The fused update+mix op,
    when set, replaces the update + gossip pair.
  * :func:`make_loop_round` — the H-step round as a Python loop over the
    stacked batches (the reference scans it inside one compiled program).
  * :func:`resolve_gossip` — gossip_impl → the whole-buffer mixing fn of
    the flat buffer or of a sweep lattice.

Randomness comes from a :class:`repro_torch.core.draws.Draws` object
passed with every call, keyed by the step counter t (the reference folds
t into its step key).

Line 4 is a :data:`GradFn` for one agent, which the engines call once,
batched over every agent row of the buffer (``flat.grads_of``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
# torch.func imports torch._dynamo at its first call, and that import
# leaves reference cycles that hold the frames on the stack at that
# moment: the engine's, with its (n, D) buffers, which then outlive the
# step until the garbage collector runs.  Importing it here, where no
# frame holds a buffer, keeps the first step's peak that of the others.
import torch._dynamo  # noqa: F401

from repro_torch.core import gossip as gossip_lib

__all__ = ["GradFn", "value_and_grad", "GOSSIP_IMPLS", "EngineOps",
           "build_step_body",
           "make_loop_round", "resolve_gossip", "check_gossip_impl",
           "unknown_gossip_impl"]

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


def resolve_gossip(source, layout: str = "flat") -> Callable:
    """gossip_impl → the whole-buffer mixing fn.

    layout 'flat': (w (n, n), x (n, D)) -> (n, D), ``source`` a config:
      'dense'  one plain matrix product (the reference leaves it to XLA);
      'pallas' the streaming gossip kernel #1 (kernels.ops.gossip_mix);
      'sparse' the ELL kernel #2 on CUDA / the plain ELL mix on the CPU
               when 0 < max_deg <= ELL_MAX_DEG, else the plain CSR gather;
      'none'   identity (FedAvg).
    layout 'sweep': (w (R, n, n), x (R, n, D)) -> (R, n, D), ``source`` a
    SweepPlan (repro/core/engine.py:177-200):
      'dense'  one batched f32 matrix product;
      'pallas' kernel #5 (kernels.ops.gossip_mix_batched), one launch;
      'sparse' the stacked-ELL kernel #6 when 0 < max_deg <= ELL_MAX_DEG,
               else the plain stacked-ELL mix;
      'none'   identity (an all-FedAvg lattice).
    The kernels (and their plain versions on the CPU) load and store the
    buffer's dtype, f32 or f64, and sum the mix in f32, as the reference's
    kernels do; 'dense', the CSR gather and the plain stacked-ELL mix
    compute in the buffer's dtype, as the reference's plain mixes do.
    """
    if layout not in ("flat", "sweep"):
        raise ValueError(f"engine layout {layout!r} is not ported; the "
                         f"port runs the 'flat' (n, D) buffer layout and "
                         f"the 'sweep' (R, n, D) lattice")
    impl = source.gossip_impl
    if impl == "none":
        return lambda w, x: x
    if impl == "dense":
        return gossip_lib.gossip_mix_dense
    if impl == "pallas":
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.gossip_mix if layout == "flat" \
            else kernel_ops.gossip_mix_batched
    if impl == "sparse":
        if layout == "flat":
            return gossip_lib.make_sparse_gossip(source.mixing.graph)
        return gossip_lib.make_sparse_gossip_batched(source.graphs)
    raise unknown_gossip_impl(impl)


@dataclasses.dataclass
class EngineOps:
    """Per-engine vtable consumed by :func:`build_step_body`.

    Fields (Algorithm-1 lines in parentheses):
      get_step:     state -> t (the carried step counter, starts at 1).
      eta_fn:       t -> η_t, a (1,) f32 tensor on the buffer's device.
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


def make_loop_round(step):
    """round_fn(state, batches, draws): ``step`` over the leading axis of
    every batch leaf; each metric stacks to (H,) + its per-step shape."""
    def round_fn(state, batches, draws):
        steps = next(iter(batches.values())).shape[0]
        per_step = []
        for h in range(steps):
            batch = {k: v[h] for k, v in batches.items()}
            state, metrics = step(state, batch, draws)
            per_step.append(metrics)
        stacked = {k: torch.stack([m[k] for m in per_step])
                   for k in per_step[0]}
        return state, stacked

    return round_fn
