"""Rematerialisation: a block's activations recomputed in the backward
(the reference's ``jax.checkpoint`` of each scanned group,
repro/models/transformer.py:289, and of each chunk of its chunked
prefill, repro/models/attention.py:144).

:func:`checkpoint` runs ``fn(*args)`` as one ``torch.autograd.Function``
that saves only its tensor inputs (a group's x and its parameter leaves,
which are views of the stacked leaves, so they cost nothing), not the
activations inside.  Its backward reruns ``fn`` under ``torch.func.vjp``
on the saved inputs and returns their vector-Jacobian product: the same
ops in the same order as the forward without it, so the loss and the
gradients are the same, bit for bit.  A collective inside ``fn`` (the
tensor-parallel conjugate pairs, sharding/tp.py) runs again in the
recompute, as the reference's recompute reruns its collectives.

``torch.utils.checkpoint`` does not compose with the torch.func
transforms that line 4 runs (``vmap`` of ``grad_and_value``): the
non-reentrant form's saved-tensor hooks are refused under them, and the
reentrant form has no ``setup_context``.  This Function has
``setup_context`` and ``generate_vmap_rule``, so ``vmap`` batches its
forward and its backward, and it runs under plain autograd too.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree

__all__ = ["checkpoint"]


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]

        def rerun(*floats):
            full = list(tensors)
            for i, t in zip(diff, floats):
                full[i] = t
            return ctx.fn(*full)

        # the vjp in the grad mode of the backward around it (the ops of
        # the plain backward), its results detached: torch.func's grad
        # differentiates with create_graph=True, under which a result
        # that kept its history would keep the recompute alive until the
        # whole backward ends
        _, vjp_fn = torch.func.vjp(rerun, *(tensors[i] for i in diff))
        out = [None] * len(tensors)
        for i, g in zip(diff, vjp_fn(grads)):
            out[i] = g.detach()
        return (None, *out)


def checkpoint(fn, *args):
    """``fn(*args)``, a tuple of tensors, with the activations inside
    ``fn`` recomputed in the backward.  ``args`` may be nested dicts,
    lists and tuples; their tensors are the Function's inputs (and get
    gradients where they are floating point), everything else is passed
    through as it is."""
    flat, spec = _pytree.tree_flatten(args)
    where = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]

    def body(*tensors):
        full = list(flat)
        for i, t in zip(where, tensors):
            full[i] = t
        out = fn(*_pytree.tree_unflatten(full, spec))
        if not (isinstance(out, tuple)
                and all(isinstance(o, torch.Tensor) for o in out)):
            raise TypeError("a checkpointed function returns a tuple of "
                            "tensors")
        return out

    return _Remat.apply(body, *(flat[i] for i in where))
