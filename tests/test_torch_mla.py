"""The port's Multi-head Latent Attention (models/mla.py) against the JAX
package's: the prefill (per-head K/V expanded from the latent, on the
plain path) and the absorbed decode against the latent cache, with a
full-rank Q (DeepSeek-V2-Lite) and with ``q_lora_rank`` (the smoke MLA
config with ``q_lora_rank=32``), causal and windowed, and a rolling
cache shorter than the tokens.

Inputs are numpy arrays from a seed; the reference's weights cross over
through ``params_from_numpy``.  Tolerances, all f32: the output within
1e-5·max|y| (other summation orders), every cache leaf within
1e-5·max|leaf| and its positions and index exactly, at each of 8 decode
steps; the port's own decode within 1e-5·max|y| of its prefill.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mla as ref_mla
from repro_torch.configs import get_config
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.models import mla
from repro_torch.tree import sorted_leaves

TOL = 1e-5
D, H = 48, 3


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


def _cfgs(q_lora: int):
    ref_cfg = ref_get_config("deepseek-v2-lite-16b").smoke().mla
    cfg = get_config("deepseek-v2-lite-16b").smoke().mla
    return (dataclasses.replace(ref_cfg, q_lora_rank=q_lora),
            dataclasses.replace(cfg, q_lora_rank=q_lora))


def _carried(ref_cfg, seed):
    p = ref_mla.init_mla(jax.random.key(seed), D, H, ref_cfg)
    # nonzero norm scales, so that the (1 + scale) form is exercised
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(0.1 * rng.standard_normal(
            x.shape, dtype=np.float32))
        if path[-2].key.endswith("norm") else x, p)
    return p, flat_lib.params_from_numpy(jax.tree.map(np.asarray, p))


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D), dtype=np.float32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                            else a)


@pytest.mark.parametrize("q_lora", [0, 32], ids=["full-q", "q-lora"])
def test_params_and_cache_match_reference_tree(q_lora):
    ref_cfg, cfg = _cfgs(q_lora)
    p, tp = _carried(ref_cfg, 0)
    own = mla.init_mla(Draws(0, "cpu"), D, H, cfg, torch.float32)
    assert [(k, tuple(v.shape)) for k, v in sorted_leaves(own)] == \
        [(k, tuple(v.shape)) for k, v in sorted_leaves(tp)]
    assert ("wq_a" in own) == bool(q_lora) and ("wq" in own) != bool(q_lora)
    want = flat_lib.params_from_numpy(jax.tree.map(
        np.asarray, ref_mla.init_mla_cache(2, 5, ref_cfg, jnp.float32)))
    got = mla.init_mla_cache(2, 5, cfg, torch.float32, device="cpu")
    for (kw, w), (kg, g) in zip(sorted_leaves(want), sorted_leaves(got)):
        assert kw == kg and w.dtype == g.dtype
        assert torch.equal(w, g)


# (B, S, window)
PREFILL = [(2, 16, 0), (1, 40, 8), (3, 7, 0)]


@pytest.mark.parametrize("b,s,window", PREFILL)
@pytest.mark.parametrize("q_lora", [0, 32], ids=["full-q", "q-lora"])
def test_prefill_matches_reference(q_lora, b, s, window):
    ref_cfg, cfg = _cfgs(q_lora)
    p, tp = _carried(ref_cfg, seed=s + q_lora)
    x, pos = _x(b, s, seed=b + s), _pos(b, s)
    want, cache = ref_mla.mla_attention(
        p, jnp.asarray(x), jnp.asarray(pos), num_heads=H, cfg=ref_cfg,
        rope_theta=1e4, window=window, compute_dtype=jnp.float32)
    got, tcache = mla.mla_attention(tp, _t(x), _t(pos), cfg=cfg,
                                    rope_theta=1e4, window=window,
                                    compute_dtype=torch.float32)
    assert cache is None and tcache is None
    _close(got, want)


# (q_lora, cache_len, steps, window): the third rolls a 4-slot ring under
# a window of 4 over 8 tokens
DECODE = [(0, 8, 8, 0), (32, 8, 8, 0), (0, 4, 8, 4), (32, 8, 8, 3)]


@pytest.mark.parametrize("q_lora,cache_len,steps,window", DECODE)
def test_absorbed_decode_matches_reference(q_lora, cache_len, steps, window):
    """Each step's output and every cache leaf against the reference's
    absorbed decode, from the same empty cache."""
    ref_cfg, cfg = _cfgs(q_lora)
    p, tp = _carried(ref_cfg, seed=cache_len + q_lora)
    b = 2
    x = _x(b, steps, seed=steps + window)
    ref_cache = ref_mla.init_mla_cache(b, cache_len, ref_cfg, jnp.float32)
    cache = mla.init_mla_cache(b, cache_len, cfg, torch.float32,
                               device="cpu")
    step = jax.jit(lambda x_, p_, c_: ref_mla.mla_attention(
        p, x_, p_, num_heads=H, cfg=ref_cfg, window=window, cache=c_,
        compute_dtype=jnp.float32))
    for t in range(steps):
        xt, pt = x[:, t:t + 1], np.full((b, 1), t, np.int32)
        want, ref_cache = step(jnp.asarray(xt), jnp.asarray(pt), ref_cache)
        got, cache = mla.mla_attention(tp, _t(xt), _t(pt), cfg=cfg,
                                       window=window, cache=cache,
                                       compute_dtype=torch.float32)
        _close(got, want, msg=f"t={t}")
        for (path, g), (_, w) in zip(sorted_leaves(cache),
                                     sorted_leaves(jax.tree.map(
                                         np.asarray, ref_cache))):
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"t={t} {path}")
            else:
                _close(g, w, msg=f"t={t} {path}")
    if cache_len < steps:   # the ring holds the last cache_len positions
        assert sorted(cache["positions"].tolist()) == \
            list(range(steps - cache_len, steps))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_lora", [0, 32], ids=["full-q", "q-lora"])
def test_absorbed_decode_reproduces_the_prefill(q_lora, window):
    """The port's own two forms on the same tokens: the latent-space
    decode, token by token, equals the expanded prefill."""
    ref_cfg, cfg = _cfgs(q_lora)
    _, tp = _carried(ref_cfg, seed=9)
    b, s = 2, 10
    x, pos = _t(_x(b, s, seed=11)), _t(_pos(b, s))
    full, _ = mla.mla_attention(tp, x, pos, cfg=cfg, window=window,
                                compute_dtype=torch.float32)
    cache = mla.init_mla_cache(b, s, cfg, torch.float32, device="cpu")
    outs = []
    for t in range(s):
        y, cache = mla.mla_attention(tp, x[:, t:t + 1], pos[:, t:t + 1],
                                     cfg=cfg, window=window, cache=cache,
                                     compute_dtype=torch.float32)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full)
