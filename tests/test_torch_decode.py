"""The port's decode path against the JAX package's: the KV cache and its
rolling window (models/attention.py), the RG-LRU and Mamba2 decode caches
and steps (models/griffin.py, models/ssm.py), the cache tree of the stack
(``init_decode_caches``) and ``Model.decode_step``, on Qwen1.5-4B,
RecurrentGemma-9B, Mamba2-2.7B, Gemma3-12B, Nemotron-4-15B and
DeepSeek-V2-Lite (MLA's absorbed decode against its latent cache, the
MoE at decode) at smoke size; the full-size cache trees of Qwen2-VL-2B
and SeamlessM4T-Large-v2 too (their decode is in
tests/test_torch_multimodal.py).

Mirrors tests/test_models.py::TestAttention::test_rolling_cache_window_decode
and tests/test_arch_smoke.py's ``test_decode_step_shapes`` and
``test_prefill_decode_agreement`` for the three ported configs.  Against
the reference: ``decode_step``'s logits within 1e-5·max|logit| and every
leaf of the new caches (within 1e-5·max|leaf|; positions and index
exactly) at each of at least 6 steps, from the reference's weights
(carried as numpy, the QKV biases made nonzero) and the same tokens, a
rolling window with cache_len < steps included, and ``long_variant`` on
Qwen1.5-4B's smoke config (window 64).  Qwen1.5-4B joins the configs
(its fields, layer plan, parameter tree and prefill logits against the
reference's), and the reference's bf16 pallas/xla gap at its smoke config
sets ``chip_smoke.BF16_REF_GAP_QWEN``, which bounds its full-model check
on the card.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.models import attention as attn_lib
from repro_torch.models import build_model, transformer
from repro_torch.tree import sorted_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
MODELS = ["qwen1.5-4b", "recurrentgemma-9b", "mamba2-2.7b", "gemma3-12b",
          "nemotron-4-15b", "deepseek-v2-lite-16b", "mistral-large-123b",
          "deepseek-v3-671b"]


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


def _tokens(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def carried():
    """name → (reference model, reference params, port model, port
    params) at smoke size; every bias leaf made nonzero on both."""
    out = {}
    for i, name in enumerate(MODELS):
        ref_model = ref_build_model(ref_get_config(name).smoke())
        params = jax.jit(ref_model.init)(jax.random.key(i))
        rng = np.random.default_rng(100 + i)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(0.1 * rng.standard_normal(
                x.shape, dtype=np.float32))
            if p[-1].key == "b" else x, params)
        out[name] = (ref_model, params,
                     build_model(get_config(name).smoke()),
                     flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                             params)))
    return out


# ---------------------------------------------------------------------------
# Qwen1.5-4B: its config, plan and weights against the reference's
# ---------------------------------------------------------------------------


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_qwen_config_matches_reference(smoke):
    ref_cfg, cfg = ref_get_config("qwen1.5-4b"), get_config("qwen1.5-4b")
    if smoke:
        ref_cfg, cfg = ref_cfg.smoke(), cfg.smoke()
    for field in dataclasses.fields(cfg):
        got, want = getattr(cfg, field.name), getattr(ref_cfg, field.name)
        if field.name.endswith("dtype"):
            assert _dtype_name(got) == jnp.dtype(want).name, field.name
        else:
            assert got == want, field.name
    assert dataclasses.astuple(transformer.plan_layers(cfg)) == \
        dataclasses.astuple(ref_transformer.plan_layers(ref_cfg))
    assert cfg.long_context_window == (64 if smoke else 4096)


def test_qwen_param_tree_has_the_reference_biases(carried):
    _, params, model, tparams = carried["qwen1.5-4b"]
    want = [(tuple(k.key for k in p), x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(params)[0]]
    own = model.init(Draws(0, "cpu"))
    got = [(p, tuple(x.shape)) for p, x in sorted_leaves(own)]
    assert got == want
    assert ("stack", "scan", "sub_0", "attn", "wq", "b") in dict(got)
    assert model.param_count(own) == sum(x.size for x in
                                         jax.tree.leaves(params))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_qwen_logits_match_reference(carried, impl):
    ref_model, params, model, tparams = carried["qwen1.5-4b"]
    tokens = _tokens(model.cfg.vocab_size, 2, 64, seed=3)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    want, _ = ref_model.logits(params, {"tokens": jnp.asarray(tokens),
                                        "positions": jnp.asarray(pos)},
                               impl=impl)
    with torch.inference_mode():
        got = model.logits(tparams, {
            "tokens": torch.from_numpy(tokens.astype(np.int64)),
            "positions": torch.from_numpy(pos.astype(np.int64))}, impl=impl)
    _close(got, want, 1e-4)


def test_reference_bf16_gap_of_qwen_sets_the_chip_bound(carried):
    """chip_smoke holds Qwen1.5-4B's bf16 pallas forward to its xla one
    within bf16_model_bound of BF16_REF_GAP_QWEN, the reference's own gap
    at the bf16-compute smoke config, measured as RecurrentGemma's and
    Mamba2's are (tests/test_torch_zoo.py).  It is larger than theirs
    (0.0078–0.0105 over 4 weight seeds, zero and random QKV biases and 2
    token draws; this draw 0.0084): one or two bf16 steps of the largest
    logit, P in f32 on one path and bf16 on the other."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ref_model, params, _, _ = carried["qwen1.5-4b"]
    ref_model = ref_build_model(dataclasses.replace(
        ref_model.cfg, compute_dtype=jnp.bfloat16))
    tokens = _tokens(ref_model.cfg.vocab_size, 2, 64, seed=4)
    batch = {"tokens": jnp.asarray(tokens), "positions": jnp.broadcast_to(
        jnp.arange(64, dtype=jnp.int32), (2, 64))}
    out = {impl: np.asarray(ref_model.logits(params, batch, impl=impl)[0],
                            np.float32) for impl in ("xla", "pallas")}
    gap = np.max(np.abs(out["pallas"] - out["xla"])) / np.max(
        np.abs(out["xla"]))
    assert smoke.BF16_REF_GAP < gap <= smoke.BF16_REF_GAP_QWEN
    assert gap >= 0.5 * smoke.BF16_REF_GAP_QWEN   # the constant is this gap
    full = get_config("qwen1.5-4b")
    assert smoke.model_tol(torch, "qwen1.5-4b", full)[0] == pytest.approx(
        2 * smoke.BF16_REF_GAP_QWEN * np.sqrt(full.num_layers / 2))


# ---------------------------------------------------------------------------
# The KV cache: tests/test_models.py::test_rolling_cache_window_decode
# ---------------------------------------------------------------------------


def test_rolling_cache_window_decode():
    """Ring-buffer cache (size < total tokens) matches full-cache decode
    for a windowed layer, and both match the reference's."""
    p = ref_attn.init_attention(jax.random.key(0), 8, 1, 1, 8)
    tp = flat_lib.params_from_numpy(jax.tree.map(np.asarray, p))
    s, window = 12, 4
    x = np.array(jax.random.normal(jax.random.key(3), (1, s, 8)))
    pos = np.arange(s, dtype=np.int32)[None]
    kw = dict(head_dim=8, window=window, compute_dtype=torch.float32)
    full = attn_lib.init_cache(1, s, 1, 8, torch.float32, device="cpu")
    ring = attn_lib.init_cache(1, window, 1, 8, torch.float32, device="cpu")
    ref_ring = ref_attn.init_cache(1, window, 1, 8, jnp.float32)
    ref_step = jax.jit(lambda x_, p_, c_: ref_attn.attention(
        p, x_, p_, cache=c_, num_kv_heads=1, head_dim=8, window=window,
        compute_dtype=jnp.float32))
    for t in range(s):
        xt, pt = x[:, t:t + 1], pos[:, t:t + 1]
        o_full, full = attn_lib.attention(
            tp, torch.from_numpy(xt), torch.from_numpy(pt.astype(np.int64)),
            cache=full, **kw)
        o_ring, ring = attn_lib.attention(
            tp, torch.from_numpy(xt), torch.from_numpy(pt.astype(np.int64)),
            cache=ring, **kw)
        o_ref, ref_ring = ref_step(jnp.asarray(xt), jnp.asarray(pt),
                                   ref_ring)
        np.testing.assert_allclose(o_full.numpy(), o_ring.numpy(),
                                   atol=1e-5, err_msg=f"t={t}")
        _close(o_ring, o_ref, msg=f"t={t}")
        for key in ("k", "v"):
            _close(ring[key], ref_ring[key], msg=f"t={t} {key}")
        for key in ("positions", "index"):
            np.testing.assert_array_equal(
                ring[key].numpy(), np.asarray(ref_ring[key]),
                err_msg=f"t={t} {key}")
    assert ring["positions"].tolist() == [8, 9, 10, 11]


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py::TestDecode, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_decode_step_shapes(carried, name):
    _, _, model, tparams = carried[name]
    b, cache_len = 2, 16
    caches = model.init_caches(b, cache_len, dtype=torch.float32,
                               device="cpu")
    tok = torch.from_numpy(_tokens(model.cfg.vocab_size, b, 1, 5)).long()
    with torch.inference_mode():
        logits, new = model.decode_step(
            tparams, {"tokens": tok, "positions": torch.zeros(b, 1,
                                                              dtype=torch.long)},
            caches)
    assert logits.shape == (b, 1, model.cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert [(p, x.shape, x.dtype) for p, x in sorted_leaves(new)] == \
        [(p, x.shape, x.dtype) for p, x in sorted_leaves(caches)]


@pytest.mark.parametrize("name", MODELS)
def test_prefill_decode_agreement(carried, name):
    """Token-by-token decode reproduces the prefill logits (the
    reference's test: 2e-3 absolute and relative; an MoE at capacity
    factor 8, where the prefill drops no token)."""
    _, _, model, tparams = carried[name]
    if model.cfg.moe is not None:
        model = build_model(dataclasses.replace(model.cfg, moe=dataclasses.
                                                replace(model.cfg.moe,
                                                        capacity_factor=8.0)))
    b, s = 2, 12
    tokens = torch.from_numpy(_tokens(model.cfg.vocab_size, b, s, 6)).long()
    positions = torch.arange(s).expand(b, s)
    with torch.inference_mode():
        full = model.logits(tparams, {"tokens": tokens,
                                      "positions": positions})
        caches = model.init_caches(b, s, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(s):
            lg, caches = model.decode_step(
                tparams, {"tokens": tokens[:, t:t + 1],
                          "positions": positions[:, t:t + 1]}, caches)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3, err_msg=name)


# ---------------------------------------------------------------------------
# decode_step and every cache leaf against the reference's
# ---------------------------------------------------------------------------


def _cache_leaves(tree, numpy: bool):
    out = sorted_leaves(jax.tree.map(np.asarray, tree) if numpy else tree)
    return [(p, np.asarray(x)) for p, x in out]


# (model, cache_len, steps, long_variant): the second, third, sixth and
# eighth roll their attention caches (4 slots, 8 tokens): Qwen's and
# DeepSeek's long-context window 64 and RecurrentGemma's and Gemma3's
# local window 32 all hold more than the ring does
DECODE_CASES = [("qwen1.5-4b", 16, 6, False), ("qwen1.5-4b", 4, 8, True),
                ("recurrentgemma-9b", 4, 8, False),
                ("mamba2-2.7b", 8, 6, False),
                ("deepseek-v2-lite-16b", 8, 6, False),
                ("deepseek-v2-lite-16b", 4, 8, True),
                ("nemotron-4-15b", 8, 6, False),
                ("gemma3-12b", 4, 8, False),
                ("mistral-large-123b", 8, 6, False),
                ("mistral-large-123b", 4, 8, True),
                ("deepseek-v3-671b", 8, 6, False),
                ("deepseek-v3-671b", 4, 8, True)]


@pytest.mark.parametrize("name,cache_len,steps,long_variant", DECODE_CASES)
def test_decode_step_matches_reference(carried, name, cache_len, steps,
                                       long_variant):
    ref_model, params, model, tparams = carried[name]
    b = 2
    tokens = _tokens(model.cfg.vocab_size, b, steps, seed=7)
    ref_caches = ref_model.init_caches(b, cache_len, dtype=jnp.float32,
                                       long_variant=long_variant)
    caches = flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                     ref_caches))
    step = jax.jit(lambda p, x, c: ref_model.decode_step(
        p, x, c, long_variant=long_variant))
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        want, ref_caches = step(params, {"tokens": tokens[:, t:t + 1],
                                         "positions": pos}, ref_caches)
        with torch.inference_mode():
            got, caches = model.decode_step(
                tparams, {"tokens": torch.from_numpy(
                    tokens[:, t:t + 1]).long(),
                    "positions": torch.from_numpy(pos).long()}, caches,
                long_variant=long_variant)
        _close(got, want, msg=f"{name} t={t} logits")
        got_leaves = _cache_leaves(caches, numpy=False)
        want_leaves = _cache_leaves(ref_caches, numpy=True)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=str(path))
            else:
                _close(g, w, msg=f"{name} t={t} {path}")
    if cache_len < steps:   # the ring wrapped: it holds the last tokens
        pos = [x for p, x in _cache_leaves(caches, False)
               if p[-1] == "positions"][0]
        assert sorted(pos.reshape(-1, cache_len)[0].tolist()) == \
            list(range(steps - cache_len, steps))


@pytest.mark.parametrize("name", MODELS + ["qwen2-vl-2b",
                                           "seamless-m4t-large-v2"])
def test_init_caches_match_the_reference_at_full_size(name):
    """Full-width cache trees (paths, shapes, dtypes) with the long
    variant's ring, on the meta device."""
    ref_model = ref_build_model(ref_get_config(name))
    model = build_model(get_config(name))
    for long_variant in (False, True):
        want = jax.eval_shape(lambda: ref_model.init_caches(
            1, 8192, long_variant=long_variant))
        got = model.init_caches(1, 8192, long_variant=long_variant,
                                device="meta")
        assert [(p, tuple(x.shape), _dtype_name(x.dtype))
                for p, x in sorted_leaves(got)] == \
            [(tuple(k.key for k in p), x.shape, x.dtype.name) for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]]
