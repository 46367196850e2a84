"""The port's zoo models against the JAX package's, by the helpers of
tests/test_torch_zoo.py (the tiny LM and the smoke configs there, the
reference's weights carried over by ``_carried``, inputs from
``_batch``): the parameter trees, ``impl='pallas'`` launching nothing on
the CPU and equal to ``impl='xla'`` (1e-4·max|logit|), ``grad_fn`` with
``impl='pallas'`` raising where a kernel is reached (DeepSeek's MLA and
MoE reach none and differentiate), the loss and grads at f32 (1e-5
relative, 1e-4·max|g|), and the bf16 bound of ``chip_smoke.py``'s
full-model check, derived from the reference's own gap between its two
paths at a bf16-compute smoke config
(``test_reference_bf16_gap_sets_the_chip_bound``; Gemma3-12B's,
Nemotron-4-15B's, Qwen2-VL-2B's and SeamlessM4T-Large-v2's gaps are
measured the same way; DeepSeek-V2-Lite's two paths are one computation,
gap 0).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops
from test_torch_zoo import (KERNEL_MODELS, MODEL_TOL, MODELS, _batch,
                            _carried, _chip_smoke, _close)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", MODELS)
def test_param_tree_matches_reference(name):
    _, params, model, tparams = _carried(name)
    ref_spec = flat_lib.make_flat_spec(tparams)
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert list(ref_spec.paths) == paths
    own = flat_lib.make_flat_spec(model.init(Draws(0, "cpu")))
    assert own.paths == ref_spec.paths and own.shapes == ref_spec.shapes


@pytest.mark.parametrize("name", MODELS)
def test_pallas_path_launches_nothing_on_the_cpu(name):
    _, _, model, tparams = _carried(name)
    _, tbatch = _batch(model.cfg, s=32)
    ops.reset_launch_counts()
    with torch.inference_mode():
        xla = model.logits(tparams, tbatch, impl="xla")
        pallas = model.logits(tparams, tbatch, impl="pallas")
    assert sum(ops.launch_counts().values()) == 0
    _close(pallas, xla, MODEL_TOL)


@pytest.mark.parametrize("name", KERNEL_MODELS)
def test_grad_fn_with_pallas_raises(name):
    _, _, model, tparams = _carried(name)
    _, tbatch = _batch(model.cfg, s=32)
    with pytest.raises(RuntimeError, match="no backward"):
        model.grad_fn(impl="pallas")(tparams, tbatch)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "deepseek-v3-671b"])
def test_deepseek_pallas_path_is_the_plain_path(name):
    """MLA and MoE have no kernel: impl='pallas' is the plain forward and
    differentiates, as the reference's does."""
    _, _, model, tparams = _carried(name)
    _, tbatch = _batch(model.cfg, s=32)
    with torch.inference_mode():
        assert torch.equal(model.logits(tparams, tbatch, impl="pallas"),
                           model.logits(tparams, tbatch, impl="xla"))
    loss, grads = model.grad_fn(impl="pallas")(tparams, tbatch)
    want_loss, want = model.grad_fn()(tparams, tbatch)
    assert float(loss) == float(want_loss)
    spec = flat_lib.make_flat_spec(tparams)
    assert torch.equal(spec.ravel(grads), spec.ravel(want))


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-2.7b",
                                  "gemma3-12b", "nemotron-4-15b",
                                  "deepseek-v2-lite-16b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2",
                                  "mistral-large-123b", "deepseek-v3-671b"])
def test_loss_and_grads_match_reference(name):
    """The training side keeps impl='xla': the new blocks differentiate."""
    ref_model, params, model, tparams = _carried(name)
    jbatch, tbatch = _batch(ref_model.cfg, s=32)
    ref_loss, ref_grads = jax.jit(ref_model.grad_fn())(params, jbatch,
                                                        jax.random.key(0))
    loss, grads = model.grad_fn()(tparams, tbatch)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    want = np.concatenate([np.ravel(g) for g in jax.tree.leaves(ref_grads)])
    got = flat_lib.make_flat_spec(tparams).ravel(grads).numpy()
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "mamba2-2.7b",
                                  "gemma3-12b", "nemotron-4-15b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2",
                                  "mistral-large-123b"])
def test_reference_bf16_gap_sets_the_chip_bound(name):
    """The reference's own |pallas − xla| / max|logit| at a bf16-compute
    smoke config: its attention keeps P in f32 on one path and casts it
    to bf16 on the other, and bf16 rounds both paths' other differences.
    ``chip_smoke.BF16_REF_GAP`` is this gap's largest value over the two
    recurrent models (RecurrentGemma's 0.00592; Mamba2's two SSD paths
    round to the same bf16 logits, gap 0); Gemma3-12B's (0.0051–0.0056
    over 3 weight seeds and 2 token draws; this draw 0.0051) is within
    it.  Nemotron-4-15B's (0.0083–0.0108 the same way; this draw 0.0095)
    sets ``chip_smoke.BF16_REF_GAP_NEMOTRON``, Qwen2-VL-2B's (0.0080–
    0.0107; this draw 0.0095) ``BF16_REF_GAP_QWEN2_VL`` and SeamlessM4T-
    Large-v2's (0.0058–0.0093; this draw 0.0093) ``BF16_REF_GAP_SEAMLESS``
    and Mistral-Large-123B's (0.0082–0.0095; this draw 0.0082)
    ``BF16_REF_GAP_MISTRAL``.
    The chip's bound for a full model scales the model's gap by
    2·√(layers / smoke layers)."""
    smoke = _chip_smoke()
    ref_model, params, _, _ = _carried(
        name, compute_dtype=(jnp.bfloat16, torch.bfloat16))
    jbatch, _ = _batch(ref_model.cfg)
    out = {impl: np.asarray(ref_model.logits(params, jbatch, impl=impl)[0],
                            np.float32) for impl in ("xla", "pallas")}
    gap = np.max(np.abs(out["pallas"] - out["xla"])) / np.max(
        np.abs(out["xla"]))
    ref_gap = smoke.BF16_REF_GAPS.get(name, smoke.BF16_REF_GAP)
    assert gap <= ref_gap
    if name != "mamba2-2.7b":
        assert gap >= 0.5 * ref_gap   # the constant is this gap
    full = get_config(name)
    bound = smoke.bf16_model_bound(full.num_layers,
                                   full.smoke().num_layers, ref_gap)
    assert bound == pytest.approx(2 * ref_gap * math.sqrt(
        full.num_layers / full.smoke().num_layers))
    assert smoke.model_tol(torch, name, full)[0] == pytest.approx(bound)
