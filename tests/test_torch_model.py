"""The port's language model against the JAX package's, and the port's own
randomness (init, data, Dirichlet draws).

The reference's parameters are carried across as numpy arrays
(``params_from_numpy``) and both models see the same numpy tokens.
Tolerances: loss relative 1e-5, gradients 1e-5·max|g| (f32, different
summation orders and transcendental implementations).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import flat as ref_flat
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.data.federated_lm import make_federated_lm
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.models.transformer import plan_layers
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = [(64, 2, 256), (128, 2, 256)]   # GQA group sizes 1 and 2
LAYOUTS = SMALL + [(64, 1, 128), (128, 3, 256)]  # unrolled / longer stacks


def _carried(d_model, layers, vocab, seed=0):
    ref_cfg = ref_train.tiny_lm_config(d_model, layers, vocab=vocab)
    ref_model = ref_build_model(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.key(seed))
    np_params = jax.tree.map(np.asarray, params)
    cfg = port_train.tiny_lm_config(d_model, layers, vocab=vocab)
    return ref_model, params, build_model(cfg), \
        flat_lib.params_from_numpy(np_params)


def _batch(vocab, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return ({"tokens": jax.numpy.asarray(tokens),
             "positions": jax.numpy.asarray(positions)},
            {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "positions": torch.from_numpy(positions.astype(np.int64))})


@pytest.mark.parametrize("d_model,layers,vocab", SMALL)
def test_loss_and_grads_match_reference(d_model, layers, vocab):
    ref_model, params, model, tparams = _carried(d_model, layers, vocab)
    jbatch, tbatch = _batch(vocab)
    ref_loss, ref_grads = jax.jit(ref_model.grad_fn())(params, jbatch,
                                                        jax.random.key(0))
    loss, grads = model.grad_fn()(tparams, tbatch)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    spec = ref_flat.make_flat_spec(params)
    want = np.asarray(spec.ravel(ref_grads))
    got = flat_lib.make_flat_spec(tparams).ravel(grads).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("d_model,layers,vocab", LAYOUTS)
def test_flat_layout_matches_reference_column_for_column(d_model, layers,
                                                         vocab):
    _, params, model, tparams = _carried(d_model, layers, vocab)
    ref_spec = ref_flat.make_flat_spec(params)
    spec = flat_lib.make_flat_spec(tparams)
    assert spec.d == ref_spec.d and spec.offsets == ref_spec.offsets
    assert spec.shapes == ref_spec.shapes
    np.testing.assert_array_equal(spec.ravel(tparams).numpy(),
                                  np.asarray(ref_spec.ravel(params)))
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(spec.paths) == paths
    # the port's own init builds the very same tree
    own = model.init(Draws(0, "cpu"))
    own_spec = flat_lib.make_flat_spec(own)
    assert own_spec.paths == spec.paths and own_spec.shapes == spec.shapes


def test_unravel_views_the_row_without_copying():
    _, _, _, tparams = _carried(64, 2, 128)
    spec = flat_lib.make_flat_spec(tparams)
    row = spec.ravel(tparams)
    tree = spec.unravel(row)
    leaf = tree["stack"]["scan"]["sub_0"]["attn"]["wq"]["w"]
    assert leaf.shape == (2, 64, 1, 64)
    assert leaf.data_ptr() >= row.data_ptr()
    leaf.zero_()
    assert spec.ravel(tree).abs().sum() < row.abs().sum() + 1


def test_tiny_config_is_the_reference_cli_default():
    ref_cfg = ref_train.tiny_lm_config()
    cfg = port_train.tiny_lm_config()
    for field in dataclasses.fields(cfg):
        if field.name.endswith("dtype"):
            continue
        assert getattr(cfg, field.name) == getattr(ref_cfg, field.name), \
            field.name
    # the reference's parameter count of the CLI default, 8 agents × D
    shapes = jax.eval_shape(ref_build_model(ref_cfg).init,
                            jax.random.key(0))
    d = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert d == 156_519_168


@pytest.mark.parametrize("n", [1, 2, 3, 12])
def test_plan_layers_matches_reference_dense_plan(n):
    from repro.models.transformer import plan_layers as ref_plan
    ref_cfg = ref_train.tiny_lm_config(64, n, vocab=128)
    cfg = port_train.tiny_lm_config(64, n, vocab=128)
    assert dataclasses.astuple(plan_layers(cfg)) == \
        dataclasses.astuple(ref_plan(ref_cfg))


# ---------------------------------------------------------------------------
# The port's own randomness: shape, dtype, determinism, simple statistics
# ---------------------------------------------------------------------------


def test_init_is_deterministic_and_scaled():
    model = build_model(port_train.tiny_lm_config(128, 2, vocab=256))
    a, b = model.init(Draws(3, "cpu")), model.init(Draws(3, "cpu"))
    c = model.init(Draws(4, "cpu"))
    spec = flat_lib.make_flat_spec(a)
    assert torch.equal(spec.ravel(a), spec.ravel(b))
    assert not torch.equal(spec.ravel(a), spec.ravel(c))
    wq = a["stack"]["scan"]["sub_0"]["attn"]["wq"]["w"]
    assert wq.dtype == torch.float32
    # truncated normal on [-2, 2] has std 0.8796; scaled by 1/sqrt(d)
    assert abs(wq.std().item() * np.sqrt(128) - 0.8796) < 0.03
    assert wq.abs().max().item() <= 2 / np.sqrt(128) + 1e-6
    assert torch.count_nonzero(a["final_norm"]["scale"]) == 0
    assert abs(a["embed"]["table"].std().item() - 0.02) < 0.002


def test_data_sampler_shapes_determinism_and_structure():
    vocab, n, s = 64, 3, 32
    d1, d2 = Draws(5, "cpu"), Draws(5, "cpu")
    data = make_federated_lm(vocab, n, s, d1, alpha=0.3)
    data2 = make_federated_lm(vocab, n, s, d2, alpha=0.3)
    probs = torch.exp(data.agent_logits)
    torch.testing.assert_close(probs.sum(-1), torch.ones(n), atol=1e-5,
                               rtol=0)
    toks = d1.tokens(data, 8, 2)
    assert toks.shape == (2, n, 8, s) and toks.dtype == torch.int64
    assert torch.equal(toks, d2.tokens(data2, 8, 2))
    assert 0 <= toks.min() and toks.max() < vocab
    # the bigram kick makes t+1 = t + 1 (mod V) far likelier than 1/V
    nxt = (toks[..., :-1] + 1) % vocab == toks[..., 1:]
    assert nxt.float().mean() > 10.0 / vocab
    # non-iid agents: their unigram distributions differ
    assert (probs[0] - probs[1]).abs().sum() > 0.5


def test_gamma_and_dirichlet_statistics():
    draws = Draws(0, "cpu")
    for alpha in (0.3, 2.5):
        g = draws.gamma(alpha, (40_000,))
        assert g.min() >= 0
        assert abs(g.mean().item() - alpha) < 0.05 * max(alpha, 1)
        assert abs(g.var().item() - alpha) < 0.1 * max(alpha, 1)
    p = draws.dirichlet(0.3, 4, 100)
    torch.testing.assert_close(p.sum(-1), torch.ones(4), atol=1e-5, rtol=0)
