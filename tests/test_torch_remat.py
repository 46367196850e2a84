"""Group rematerialisation (models/remat.py, ``remat`` of
``transformer.forward``, ``Model.logits``/``loss``/``grad_fn``) against the
JAX package, whose ``_apply_stack`` checkpoints each scanned group
(repro/models/transformer.py:289, ``remat=True`` by default).

Inputs are numpy arrays from a seed: the reference model's initial
parameters, perturbed row by row, and one token batch per row.  Line 4's
form runs on both sides: ``torch.func.vmap`` of ``grad_fn`` over the rows
against ``jax.vmap`` of the reference's ``grad_fn(remat=True)``.

Cases: the tiny LM (one layer a group), Gemma3-12B's smoke config at 4
layers (a group of period 2, its local and global layers, at a sequence
past the local window) and DeepSeek-V2-Lite's at 3 layers (a dense
prefix layer, then two MoE groups, whose aux loss leaves the Function).

Tolerances: the port with remat on and off equal bit for bit (loss and
every gradient); either against the reference within 1e-5·max|g| (f32,
other summation orders), losses relative 1e-5.
"""

from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.core.draws import ShapeDraws
from repro_torch.launch import train as port_train
from repro_torch.launch import trace_analysis
from repro_torch.models import build_model, transformer
from repro_torch.models.model import Model
from repro_torch.tree import leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ("tiny", "gemma3-12b", "deepseek-v2-lite-16b")
LAYERS = {"gemma3-12b": 4, "deepseek-v2-lite-16b": 3}
ROWS, SEQ = 3, 48
TOL, LOSS_RTOL = 1e-5, 1e-5


def _configs(name: str):
    """(reference config, port config)."""
    if name == "tiny":
        return (ref_train.tiny_lm_config(64, 3, vocab=256),
                port_train.tiny_lm_config(64, 3, vocab=256))
    return (dataclasses.replace(ref_get_config(name).smoke(),
                                num_layers=LAYERS[name]),
            dataclasses.replace(get_config(name).smoke(),
                                num_layers=LAYERS[name]))


def _inputs(name: str, seed: int = 0):
    """(reference model, port model, stacked numpy params, numpy batch)."""
    ref_cfg, cfg = _configs(name)
    ref_model = ref_build_model(ref_cfg)
    params = jax.tree.map(np.asarray,
                          jax.jit(ref_model.init)(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    stacked = jax.tree.map(lambda p: (p[None] + 0.02 * rng.standard_normal(
        (ROWS,) + p.shape)).astype(np.float32), params)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, 2, SEQ)),
             "positions": np.broadcast_to(np.arange(SEQ),
                                          (ROWS, 2, SEQ)).copy()}
    return ref_model, build_model(cfg), stacked, batch


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                    tree)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """The port's line 4 with remat on and off, and the reference's."""
    ref_model, model, stacked, batch = _inputs(request.param)
    keys = jax.random.split(jax.random.key(0), ROWS)
    want = jax.jit(jax.vmap(ref_model.grad_fn(remat=True)))(
        jax.tree.map(jnp.asarray, stacked),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}, keys)
    tparams, tbatch = _torch(stacked), _torch(batch)
    got = {remat: torch.func.vmap(model.grad_fn(remat=remat))(tparams,
                                                               tbatch)
           for remat in (True, False)}
    return {"name": request.param, "model": model, "got": got,
            "want": jax.tree.map(np.asarray, want), "params": tparams,
            "batch": tbatch}


def _flat(tree) -> np.ndarray:
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).ravel()


def test_remat_on_and_off_are_equal_bit_for_bit(case):
    (l_on, g_on), (l_off, g_off) = case["got"][True], case["got"][False]
    assert torch.equal(l_on, l_off)
    for a, b in zip(leaves(g_on), leaves(g_off)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False], ids=["on", "off"])
def test_grads_match_the_reference_remat(case, remat):
    losses, grads = case["got"][remat]
    want_l, want_g = case["want"]
    np.testing.assert_allclose(losses.numpy(), want_l, rtol=LOSS_RTOL)
    got, want = _flat(tree_map(lambda t: t.numpy(), grads)), _flat(want_g)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * scale, (err, scale)


def _remat_nodes(loss: torch.Tensor) -> int:
    """The rematerialised units in a loss's autograd graph."""
    seen, todo, count = set(), [loss.grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        count += type(node).__name__ == "_RematBackward"
        todo.extend(f for f, _ in node.next_functions)
    return count


def test_each_scanned_group_is_one_rematerialised_unit(case):
    """With remat, one Function a scanned group (the prefix and suffix
    layers keep their activations); without it, none."""
    model = case["model"]
    plan = transformer.plan_layers(model.cfg)
    params = tree_map(lambda t: t[0].clone().requires_grad_(),
                      case["params"])
    batch = tree_map(lambda t: t[0], case["batch"])
    assert _remat_nodes(model.loss(params, batch)) == plan.n_groups > 0
    assert _remat_nodes(model.loss(params, batch, remat=False)) == 0


def test_grad_fn_rematerialises_by_default():
    """The reference's signatures and defaults: remat on for logits,
    loss and grad_fn; a decode step never rematerialises."""
    for fn in (Model.logits, Model.loss, Model.grad_fn, transformer.forward):
        assert inspect.signature(fn).parameters["remat"].default is True
    cfg = port_train.tiny_lm_config(64, 3, vocab=256)
    model = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(ShapeDraws("cpu")))
    caches = model.init_caches(1, 8, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.long),
             "positions": torch.zeros((1, 1), dtype=torch.long)}
    logits, _ = model.decode_step(params, batch, caches)
    assert _remat_nodes(logits.sum()) == 0


def test_dry_run_tally_counts_the_recompute():
    """On meta tensors the tally sees the group's forward twice: the
    rematerialised step's FLOPs are its forward's more than the plain
    step's, by one forward of the groups, and its peak is lower."""
    cfg = port_train.tiny_lm_config(64, 4, vocab=256)
    model = build_model(cfg)
    params = model.init_shapes()
    batch = {"tokens": torch.zeros((2, 256), dtype=torch.long,
                                   device="meta"),
             "positions": torch.zeros((2, 256), dtype=torch.long,
                                      device="meta")}
    costs = {remat: trace_analysis.tally(model.grad_fn(remat=remat), params,
                                         batch)[1] for remat in (True, False)}
    _, fwd = trace_analysis.tally(
        lambda p, b: model.loss(p, b, remat=False), params, batch)
    extra = costs[True].flops - costs[False].flops
    assert 0 < extra < fwd.flops
    assert costs[True].peak_bytes < costs[False].peak_bytes
