"""The port's MoE layer (models/moe.py) against the JAX package's, and
DeepSeek-V2-Lite's MoE stack through the whole model.

Inputs are numpy arrays from a seed, handed to both; the reference's
weights cross over through ``params_from_numpy``.  The routing (top-k
experts, renormalised weights, each copy's rank within its expert and
the keep mask) is held to the reference's exactly, with the weights to
1e-6; the layer's output and aux loss at f32 to 1e-5·max|y| (other
summation orders), with and without shared experts, at the default
capacity and at capacities where copies drop.  Under
``torch.func.vmap`` over 3 agent rows the layer and its gradient equal
the per-row calls (the engines vmap ``Model.grad_fn``).  The model:
DeepSeek-V2-Lite's smoke config at 3 layers (a dense prefix and two MoE
layers as one scanned group) against the reference's logits
(1e-4·max|logit|), loss with the aux term (1e-5 relative) and grads
(1e-5·max|g|); its plan at full depth is prefix 1 + 26 groups.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models.transformer import plan_layers as ref_plan_layers
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import plan_layers
from repro_torch.tree import leaves, tree_map

TOL = 1e-5
D = 32


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _cfgs(**kw):
    base = dict(num_experts=4, num_shared=1, top_k=2, d_ff_expert=16)
    base.update(kw)
    return RefMoEConfig(**base), MoEConfig(**base)


def _carried(ref_cfg, seed=0):
    p = ref_moe.init_moe(jax.random.key(seed), D, ref_cfg)
    return p, flat_lib.params_from_numpy(jax.tree.map(np.asarray, p))


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D), dtype=np.float32)


# ---------------------------------------------------------------------------
# Capacity, ranks and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 16, 48, 4096])
@pytest.mark.parametrize("cf", [1.25, 64 / 6, 0.1])
def test_expert_capacity_matches_reference(n, cf):
    ref_cfg, cfg = _cfgs(num_experts=64, top_k=6, capacity_factor=cf)
    assert moe.expert_capacity(n, cfg) == ref_moe.expert_capacity(n, ref_cfg)


@pytest.mark.parametrize("nk,e", [(1, 4), (40, 4), (600, 64), (97, 3)])
def test_rank_within_expert_matches_reference(nk, e):
    flat = np.random.default_rng(nk + e).integers(0, e, nk)
    want = np.asarray(ref_moe._rank_within_expert(jnp.asarray(flat), e))
    got = moe._rank_within_expert(torch.from_numpy(flat), e)
    np.testing.assert_array_equal(got.numpy(), want)


def _ref_routing(p, x, cfg, capacity):
    """The reference's routing of moe_layer, step by step."""
    n = x.shape[0] * x.shape[1]
    tokens = jnp.asarray(x).reshape(n, D)
    probs = jax.nn.softmax(ref_layers.dense(p["router"], tokens), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    weights = top_p / (top_p.sum(-1, keepdims=True) + 1e-9)
    flat_e = top_e.reshape(n * cfg.top_k)
    rank = ref_moe._rank_within_expert(flat_e, cfg.num_experts)
    return (np.asarray(top_e), np.asarray(weights), np.asarray(rank),
            np.asarray(rank < capacity))


@pytest.mark.parametrize("b,s,capacity", [(2, 8, None), (1, 48, 3),
                                          (3, 5, 1)])
def test_routing_matches_reference(b, s, capacity):
    ref_cfg, cfg = _cfgs()
    p, tp = _carried(ref_cfg, seed=b * s)
    x = _x(b, s, seed=s)
    c = capacity or moe.expert_capacity(b * s, cfg)
    top_e, weights, rank, keep = _ref_routing(p, x, ref_cfg, c)
    _, got_e, got_w = moe._route(tp["router"],
                                 torch.from_numpy(x).reshape(-1, D), 2)
    got_rank = moe._rank_within_expert(got_e.reshape(-1), 4)
    np.testing.assert_array_equal(got_e.numpy(), top_e)
    np.testing.assert_allclose(got_w.numpy(), weights, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_rank.numpy(), rank)
    np.testing.assert_array_equal((got_rank < c).numpy(), keep)
    if capacity is not None and capacity < 4:
        assert not keep.all()   # copies drop at this capacity


@pytest.mark.parametrize("b,s", [(2, 64), (1, 300)])
def test_deepseek_v3_routing_at_256_experts_top_8(b, s):
    """DeepSeek-V3's own router, 256 experts and top-8 (one shared expert,
    capacity factor 1.25), at narrow widths (d 32, expert d_ff 16): the
    chosen experts, their weights, the ranks and the kept copies equal
    the reference's, and so does the layer's output within TOL."""
    ref_cfg, cfg = _cfgs(num_experts=256, top_k=8, num_shared=1,
                         capacity_factor=1.25)
    p, tp = _carried(ref_cfg, seed=b * s)
    x = _x(b, s, seed=s)
    c = moe.expert_capacity(b * s, cfg)
    top_e, weights, rank, keep = _ref_routing(p, x, ref_cfg, c)
    _, got_e, got_w = moe._route(tp["router"],
                                 torch.from_numpy(x).reshape(-1, D), 8)
    got_rank = moe._rank_within_expert(got_e.reshape(-1), 256)
    np.testing.assert_array_equal(got_e.numpy(), top_e)
    np.testing.assert_allclose(got_w.numpy(), weights, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_rank.numpy(), rank)
    np.testing.assert_array_equal((got_rank < c).numpy(), keep)
    want, want_aux = ref_moe.moe_layer(p, jnp.asarray(x), ref_cfg,
                                       compute_dtype=jnp.float32)
    got, aux = moe.moe_layer(tp, torch.from_numpy(x), cfg,
                             compute_dtype=torch.float32)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

# (shared experts, B, S, capacity override, capacity factor): the default
# capacity, a factor of 0.5 and overrides of 1 and 3 drop copies
LAYER_CASES = [(1, 2, 8, None, 1.25), (0, 2, 8, None, 1.25),
               (1, 1, 48, None, 0.5), (1, 3, 5, 1, 1.25),
               (2, 1, 48, 3, 1.25), (1, 1, 1, None, 1.25)]


@pytest.mark.parametrize("shared,b,s,capacity,cf", LAYER_CASES)
def test_moe_layer_matches_reference(shared, b, s, capacity, cf):
    ref_cfg, cfg = _cfgs(num_shared=shared, capacity_factor=cf)
    p, tp = _carried(ref_cfg, seed=shared + s)
    x = _x(b, s, seed=b + s)
    want, want_aux = ref_moe.moe_layer(p, jnp.asarray(x), ref_cfg,
                                       compute_dtype=jnp.float32,
                                       capacity=capacity)
    got, aux = moe.moe_layer(tp, torch.from_numpy(x), cfg,
                             compute_dtype=torch.float32, capacity=capacity)
    assert ("shared" in tp) == bool(shared)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


def test_dropped_copies_change_the_output():
    """At capacity 1 the layer differs from the drop-free one (copies
    really drop), and both match the reference."""
    ref_cfg, cfg = _cfgs()
    p, tp = _carried(ref_cfg)
    x = torch.from_numpy(_x(1, 16, seed=3))
    full, _ = moe.moe_layer(tp, x, cfg, compute_dtype=torch.float32,
                            capacity=16)
    cut, _ = moe.moe_layer(tp, x, cfg, compute_dtype=torch.float32,
                           capacity=1)
    assert (full - cut).abs().max() > 1e-3
    want, _ = ref_moe.moe_layer(p, jnp.asarray(x.numpy()), ref_cfg,
                                compute_dtype=jnp.float32, capacity=1)
    _close(cut, want)


def test_moe_layer_params_match_reference_tree():
    ref_cfg, cfg = _cfgs(num_shared=2)
    p, _ = _carried(ref_cfg)
    own = moe.init_moe(Draws(0, "cpu"), D, cfg, torch.float32)
    want = flat_lib.make_flat_spec(flat_lib.params_from_numpy(
        jax.tree.map(np.asarray, p)))
    got = flat_lib.make_flat_spec(own)
    assert got.paths == want.paths and got.shapes == want.shapes


def test_moe_layer_under_vmap_equals_the_per_row_loop():
    """3 agent rows of weights and inputs: torch.func.vmap of the layer
    and of its gradient equal the per-row calls (f32; the same ops)."""
    ref_cfg, cfg = _cfgs(capacity_factor=0.75)
    rows = [_carried(ref_cfg, seed=r)[1] for r in range(3)]
    stacked = tree_map(lambda *a: torch.stack(a), *rows)
    x = torch.from_numpy(np.stack([_x(2, 6, seed=r) for r in range(3)]))

    def loss(p, xx):
        out, aux = moe.moe_layer(p, xx, cfg, compute_dtype=torch.float32)
        return (out ** 2).mean() + 1e-3 * aux

    out, aux = torch.func.vmap(lambda p, xx: moe.moe_layer(
        p, xx, cfg, compute_dtype=torch.float32))(stacked, x)
    grads, values = torch.func.vmap(torch.func.grad_and_value(loss))(
        stacked, x)
    for r in range(3):
        want, want_aux = moe.moe_layer(rows[r], x[r], cfg,
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(out[r].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
        assert float(aux[r]) == pytest.approx(float(want_aux), rel=1e-6)
        g, v = torch.func.grad_and_value(loss)(rows[r], x[r])
        assert float(values[r]) == pytest.approx(float(v), rel=1e-6)
        for a, b in zip(leaves(grads), leaves(g)):
            np.testing.assert_allclose(a[r].numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * max(b.abs().max(), 1e-30))


# ---------------------------------------------------------------------------
# DeepSeek-V2-Lite's MoE stack through the model
# ---------------------------------------------------------------------------


def _three_layers():
    ref_cfg = dataclasses.replace(
        ref_get_config("deepseek-v2-lite-16b").smoke(), num_layers=3)
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").smoke(),
                              num_layers=3)
    return ref_cfg, cfg


def test_deepseek_plans_a_dense_prefix_and_moe_groups():
    full = get_config("deepseek-v2-lite-16b")
    assert dataclasses.astuple(plan_layers(full)) == (1, 1, 26, 0)
    ref_cfg, cfg = _three_layers()
    assert dataclasses.astuple(plan_layers(cfg)) == \
        dataclasses.astuple(ref_plan_layers(ref_cfg)) == (1, 1, 2, 0)


def test_deepseek_three_layers_match_reference():
    """Logits, loss (with the router aux term) and grads of the smoke
    config at 3 layers, whose two MoE layers form the scanned group."""
    ref_cfg, cfg = _three_layers()
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = jax.jit(ref_model.init)(jax.random.key(4))
    tparams = flat_lib.params_from_numpy(jax.tree.map(np.asarray, params))
    assert "moe" in tparams["stack"]["scan"]["sub_0"]
    assert "mlp" in tparams["stack"]["pre_0"]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    jbatch = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)}
    tbatch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
              "positions": torch.from_numpy(pos.astype(np.int64))}
    want, ref_aux = ref_model.logits(params, jbatch)
    with torch.inference_mode():
        got = model.logits(tparams, tbatch)
    _close(got, want, 1e-4)
    ref_loss, ref_grads = jax.jit(ref_model.grad_fn())(params, jbatch,
                                                        jax.random.key(0))
    loss, grads = model.grad_fn()(tparams, tbatch)
    assert float(ref_aux) > 0
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    # the aux term is in the loss: without it the losses part
    no_aux = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0)))
    assert float(no_aux.loss(tparams, tbatch)) == pytest.approx(
        float(loss) - 1e-3 * float(ref_aux), rel=1e-6)
    want_g = np.concatenate([np.ravel(g) for g in jax.tree.leaves(ref_grads)])
    got_g = flat_lib.make_flat_spec(tparams).ravel(grads).numpy()
    _close(got_g, want_g, TOL)
