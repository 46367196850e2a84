"""The chunked prefill (models/attention.py ``_chunked_prefill`` and its
routing by ``attn_chunked_prefill``; MLA's prefill, which always scans)
against the JAX package's ``_chunked_prefill``
(repro/models/attention.py:101-160), ``attention`` and ``mla_attention``.

Inputs are numpy arrays from a seed.  Sequences of 1,024 and 1,536
queries take two and three chunks of 512; 640 does not divide the chunk
and takes the one dense block on the given positions (as the reference
does; a sequence of 128 never reaches the scan).  Cases: causal,
windowed, the encoder's unmasked self-attention, cross-attention to a
memory of T ≠ S keys (through ``attention(kv_override=...)``), and MLA's
V padded to the QK head dim (through ``mla_attention``).

Tolerances: 1e-5·max|y| at f32 (other summation orders); at bf16 2^-7·
max|y|, one bf16 rounding step at the largest output (the PV product
runs in bf16 on both sides, each rounding its own way).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import mla as ref_mla
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.launch import train as port_train
from repro_torch.models import attention, build_model, mla
from repro_torch.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEQS = (640, 1024, 1536)
TOL, BF16_TOL = 1e-5, 2.0 ** -7
B, H, KV, HD = 1, 4, 2, 32
T_CROSS = 320
KINDS = ("causal", "windowed", "encoder")


def _qkv(s: int, t: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, H, HD)).astype(np.float32),
            rng.standard_normal((B, t, KV, HD)).astype(np.float32),
            rng.standard_normal((B, t, KV, HD)).astype(np.float32))


def _pos(s: int) -> np.ndarray:
    return np.broadcast_to(np.arange(s), (B, s)).copy()


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


KIND_ARGS = {"causal": (0, True), "windowed": (300, True),
             "encoder": (0, False)}


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_prefill_matches_reference(kind, s):
    window, causal = KIND_ARGS[kind]
    q, k, v = _qkv(s, s)
    want = ref_attn._chunked_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_pos(s)), jnp.asarray(_pos(s)), scale=HD ** -0.5,
        window=window, causal=causal)
    got = attention._chunked_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(_pos(s)), torch.from_numpy(_pos(s)), HD ** -0.5,
        window, causal)
    _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("s", SEQS)
def test_chunked_prefill_bf16_within_one_rounding_step(s):
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(s, s, seed=1))
    want = ref_attn._chunked_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(_pos(s)), jnp.asarray(_pos(s)), scale=HD ** -0.5,
        window=0, causal=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    got = attention._chunked_prefill(tq, tk, tv, torch.from_numpy(_pos(s)),
                                     torch.from_numpy(_pos(s)), HD ** -0.5)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)


def _attn_params(d: int, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)

    def w(*shape):
        return {"w": (rng.standard_normal(shape) / np.sqrt(shape[0])
                      ).astype(np.float32)}

    return {"wq": w(d, H, HD), "wk": w(d, KV, HD), "wv": w(d, KV, HD),
            "wo": w(H, HD, d)}


@pytest.mark.parametrize("s", SEQS)
def test_cross_attention_chunked_matches_reference(s):
    """Cross-attention to T ≠ S encoder keys (unmasked, no rope)."""
    d = 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    mem = rng.standard_normal((B, T_CROSS, d)).astype(np.float32)
    params = _attn_params(d)
    want, _ = ref_attn.attention(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(_pos(s)), num_kv_heads=KV, head_dim=HD,
        rope_kind="none", kv_override=jnp.asarray(mem), causal=False,
        compute_dtype=jnp.float32)
    got, _ = attention.attention(
        tree_map(torch.from_numpy, params), torch.from_numpy(x),
        torch.from_numpy(_pos(s)), head_dim=HD, rope_kind="none",
        kv_override=torch.from_numpy(mem), causal=False)
    _close(got.numpy(), want, TOL)


def _mla_params(seed: int = 4):
    """DeepSeek-V2-Lite's smoke MLA: its config and random weights."""
    ref_cfg = ref_get_config("deepseek-v2-lite-16b").smoke()
    cfg = get_config("deepseek-v2-lite-16b").smoke()
    params = jax.tree.map(np.asarray, ref_mla.init_mla(
        jax.random.key(seed), ref_cfg.d_model, ref_cfg.num_heads,
        ref_cfg.mla))
    return ref_cfg, cfg, params


@pytest.mark.parametrize("s", SEQS)
def test_mla_prefill_pads_v_and_scans_as_the_reference(s):
    ref_cfg, cfg, params = _mla_params()
    assert cfg.mla.v_head_dim < cfg.mla.qk_nope_head_dim \
        + cfg.mla.qk_rope_head_dim
    x = np.random.default_rng(5).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    want, _ = ref_mla.mla_attention(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(_pos(s)), num_heads=ref_cfg.num_heads, cfg=ref_cfg.mla,
        compute_dtype=jnp.float32)
    got, _ = mla.mla_attention(
        tree_map(torch.from_numpy, params), torch.from_numpy(x),
        torch.from_numpy(_pos(s)), cfg=cfg.mla, compute_dtype=torch.float32)
    _close(got.numpy(), want, TOL)


@pytest.fixture
def spy(monkeypatch):
    """The query rows of every block the plain prefill attends, and the
    flash kernel's calls."""
    rows, flash = [], []
    block = attention._attend_block

    def attend(q, *a, **kw):
        rows.append(q.shape[1])
        return block(q, *a, **kw)

    def fake_flash(q, k, v, **kw):
        flash.append(q.shape[1])
        return block(q, k, v, *(torch.arange(q.shape[1])[None],) * 2,
                     kw["scale"], kw["window"])

    from repro_torch.kernels import ops
    monkeypatch.setattr(attention, "_attend_block", attend)
    monkeypatch.setattr(ops, "flash_attention", fake_flash)
    return rows, flash


@pytest.mark.parametrize("chunked", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("case", ["xla", "pallas-encoder", "pallas-cross",
                                  "pallas-causal"])
def test_the_flag_routes_as_the_reference(spy, case, chunked):
    """``impl='pallas'`` with a causal self-attention launches #15 whatever
    the flag says; every other prefill runs the chunks of 512 with the
    flag on and one block with it off (repro/models/attention.py:
    249-264)."""
    rows, flash = spy
    s, d = 1024, 64
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((B, s, d)).astype(np.float32))
    pos = torch.from_numpy(_pos(s))
    params = tree_map(torch.from_numpy, _attn_params(d))
    kw = dict(head_dim=HD, chunked_prefill=chunked)
    if case == "pallas-encoder":
        kw.update(impl="pallas", causal=False)
    elif case == "pallas-cross":
        kw.update(impl="pallas", rope_kind="none", causal=False,
                  kv_override=x[:, :T_CROSS])
    elif case == "pallas-causal":
        kw.update(impl="pallas")
    attention.attention(params, x, pos, **kw)
    if case == "pallas-causal":
        assert flash == [s] and rows == []
    else:
        assert flash == [] and rows == ([512, 512] if chunked else [s])


def test_chunks_of_a_sequence_block_take_their_true_offsets():
    """The rank's rows of a sequence split over a model group (layout
    (c)): its chunks are masked at their offsets in the whole sequence."""
    s, lo, c = 1536, 768, 768
    q, k, v = (torch.from_numpy(a) for a in _qkv(s, s, seed=7))
    pos = torch.from_numpy(_pos(s))
    whole = attention._chunked_prefill(q, k, v, pos, pos, HD ** -0.5, 300)
    part = attention._chunked_prefill(q[:, lo:lo + c], k, v,
                                      pos[:, lo:lo + c], pos, HD ** -0.5,
                                      300, q_offset=lo, s_total=s)
    _close(part.numpy(), whole[:, lo:lo + c].numpy(), TOL)


def test_chunked_backward_matches_the_one_block():
    """The chunk bodies recompute their probabilities in the backward:
    the gradients equal the one block's within 1e-5·max|g|."""
    s = 1024
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(s, s, seed=8))
    pos = torch.from_numpy(_pos(s))
    grads = []
    for chunked in (True, False):
        y = attention._prefill(q, k, v, pos, pos, HD ** -0.5, 100, True,
                               chunked)
        grads.append(torch.autograd.grad((y * y).sum(), (q, k, v)))
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy(), TOL)


def test_model_logits_chunked_match_reference_and_the_one_block():
    """The tiny LM at S = 1,024 with the flag on against the reference's
    logits (1e-5·max|logit|), and against the port's with it off."""
    s = 1024
    ref_cfg = ref_train.tiny_lm_config(64, 2, vocab=256)
    cfg = port_train.tiny_lm_config(64, 2, vocab=256)
    ref_model = ref_build_model(ref_cfg)
    params = jax.tree.map(np.asarray,
                          jax.jit(ref_model.init)(jax.random.key(0)))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, 256, (1, s)), "positions": _pos(s)}
    want, _ = jax.jit(ref_model.logits)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(a, jnp.int32) for k, a in batch.items()})
    tparams = tree_map(torch.from_numpy, params)
    tbatch = tree_map(torch.from_numpy, batch)
    with torch.no_grad():
        on = build_model(cfg).logits(tparams, tbatch)
        off = build_model(dataclasses.replace(
            cfg, attn_chunked_prefill=False)).logits(tparams, tbatch)
    _close(on.numpy(), want, TOL)
    _close(off.numpy(), on.numpy(), TOL)
