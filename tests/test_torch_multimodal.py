"""The multimodal pair against the JAX package: Qwen2-VL-2B (M-RoPE and
the vision-stub patch prefix) and SeamlessM4T-Large-v2 (the encoder and
the decoder's cross-attention), at their smoke configs, and the batch
schema of ``launch/specs.py``.

Covered: ``layers.apply_mrope`` with three distinct (t, h, w) position
components (the reference's own ``concrete_batch`` gives all three the
same positions, under which M-RoPE is RoPE and a wrong section order
would pass), cross-attention and the encoder's unmasked attention,
``Model.encode``, the loss with the patch mask (with and without the
patch embeddings in the batch), ``decode_step`` and its caches, the
prefill↔decode agreement of tests/test_arch_smoke.py, greedy
``generate`` and ``generate_personalized``, one FedDec tree step over 4
agents (tests/test_arch_smoke.py::TestFedTrainStep, the reference's
server draws replayed) and tests/test_substrate.py::TestInputSpecs.  The
models' configs, plans, parameter trees, prefill logits under both
impls, loss and grads and bf16 gaps are in tests/test_torch_zoo.py; their
checkpoint files in tests/test_torch_checkpoint.py.

Inputs are numpy arrays from a seed, handed to both packages; the
reference's weights cross over through ``params_from_numpy`` (every bias
leaf made nonzero).  Tolerances, all f32: 1e-5·max|y| per function
(M-RoPE, attention, the encoder memory, the FedDec step's parameters),
1e-5·max|logit| per decode step, 2e-3 for prefill against decode (the
reference's test); bf16 M-RoPE to one bf16 step (2^-8·max|y|); tokens
exactly.
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.core import FedDecConfig as RefFedDecConfig
from repro.core import init_state as ref_init_state
from repro.core import make_feddec_step as ref_make_feddec_step
from repro.core import flat as ref_flat
from repro.core import topology as ref_topo
from repro.core.mixing import MixingDistribution as RefMixing
from repro.launch import serve as ref_serve
from repro.launch import specs as ref_specs
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import feddec
from repro_torch.core import flat as flat_lib
from repro_torch.core import topology as topo
from repro_torch.core.draws import Draws
from repro_torch.core.mixing import MixingDistribution
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.serve import generate, generate_personalized
from repro_torch.models import attention as attn_lib
from repro_torch.models import build_model, transformer
from repro_torch.models import layers as layers_lib
from repro_torch.tree import leaves, sorted_leaves
from test_torch_feddec import ReplayTreeDraws
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
NAMES = ["qwen2-vl-2b", "seamless-m4t-large-v2"]
N_AGENTS = 4


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                            else a)


def _mrope_positions(rng, b, s, lead=()):
    """(3, B, S) ids (an agent dim first with ``lead``): the temporal
    component the sequence position, height and width drawn, so the
    three differ."""
    t = np.broadcast_to(np.arange(s, dtype=np.int32), lead + (b, s))
    hw = rng.integers(0, s, size=(2,) + lead + (b, s)).astype(np.int32)
    return np.moveaxis(np.concatenate([t[None], hw]), 0, len(lead))


def _inputs(cfg, b, s, seed, enc_len=6, lead=()):
    """numpy batch of ``cfg`` (either package's config) with every input
    its model takes."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=lead + (b, s)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                        lead + (b, s)).copy()}
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = _mrope_positions(rng, b, s, lead)
    if cfg.frontend == "vision":
        out["frontend_embeds"] = 0.02 * rng.standard_normal(
            lead + (b, cfg.frontend_positions, cfg.d_model),
            dtype=np.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = 0.02 * rng.standard_normal(
            lead + (b, enc_len, cfg.d_model), dtype=np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def carried():
    """name → (reference model, its params, port model, the same params
    carried over) at smoke size, every bias leaf nonzero."""
    out = {}
    for i, name in enumerate(NAMES):
        ref_model = ref_build_model(ref_get_config(name).smoke())
        params = jax.jit(ref_model.init)(jax.random.key(i))
        rng = np.random.default_rng(200 + i)
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
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
def test_apply_mrope_matches_reference(hd, dtype):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd), dtype=np.float32)
    pos = _mrope_positions(rng, 2, 9) * 97    # ids up to ~800
    want = ref_layers.apply_mrope(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(pos), 1e6)
    got = layers_lib.apply_mrope(_t(x).to(getattr(torch, dtype)), _t(pos),
                                 1e6)
    assert str(got.dtype) == f"torch.{dtype}"
    # bf16: one rounding of the same f32 value on both sides
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           TOL if dtype == "float32" else 2.0 ** -8)


@pytest.mark.parametrize("hd", [64, 128])
def test_apply_mrope_of_equal_components_is_apply_rope(hd):
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 7, 2, hd), dtype=np.float32))
    pos = _t(rng.integers(0, 5000, size=(2, 7)).astype(np.int32))
    assert torch.equal(layers_lib.apply_mrope(x, pos.expand(3, 2, 7)),
                       layers_lib.apply_rope(x, pos))


def test_mrope_sections_are_the_reference_split():
    """(half − 2·(half//4), half//4, half//4): (32, 16, 16) at head_dim
    128, (16, 8, 8) at the smoke's 64; the h and w bands rotate by their
    own components (swapping the two moves the output)."""
    assert layers_lib.mrope_sections(128) == (32, 16, 16)
    assert layers_lib.mrope_sections(64) == (16, 8, 8)
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((1, 5, 1, 64), dtype=np.float32))
    pos = _t(_mrope_positions(rng, 1, 5))
    swapped = pos[[0, 2, 1]]
    assert not torch.equal(layers_lib.apply_mrope(x, pos),
                           layers_lib.apply_mrope(x, swapped))
    with pytest.raises(ValueError, match="sections"):
        layers_lib.apply_mrope(x, pos, sections=(16, 8, 4))


def test_apply_mrope_batches_under_vmap():
    """The engines vmap the batch dict, (n, 3, B, S) positions with the
    agent axis first: the same numbers as one call per agent, and no op
    falls back to vmap's per-lane loop."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((4, 2, 6, 2, 64), dtype=np.float32))
    pos = _t(_mrope_positions(rng, 2, 6, lead=(4,)))
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            got = torch.func.vmap(layers_lib.apply_mrope)(x, pos)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for i in range(4):
        assert torch.equal(got[i], layers_lib.apply_mrope(x[i], pos[i]))


# ---------------------------------------------------------------------------
# Attention: cross, unmasked, M-RoPE
# ---------------------------------------------------------------------------

# (case, heads, kv heads): the decoder's cross-attention (T = 9 frames,
# GQA 2:1), the encoder's unmasked self-attention, M-RoPE causal
ATTENTION = [("cross", 4, 2), ("unmasked", 4, 4), ("mrope", 4, 2)]


@pytest.mark.parametrize("case,h,kv", ATTENTION)
def test_attention_matches_reference(case, h, kv):
    d, hd, b, s = 32, 16, 2, 7
    p = ref_attn.init_attention(jax.random.key(1), d, h, kv, hd, bias=True)
    tp = flat_lib.params_from_numpy(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ref_kw = dict(num_kv_heads=kv, head_dim=hd, compute_dtype=jnp.float32)
    kw = dict(head_dim=hd, compute_dtype=torch.float32)
    if case == "cross":
        mem = rng.standard_normal((b, 9, d), dtype=np.float32)
        ref_kw.update(rope_kind="none", kv_override=jnp.asarray(mem),
                      causal=False)
        kw.update(rope_kind="none", kv_override=_t(mem), causal=False)
    elif case == "unmasked":
        ref_kw.update(causal=False)
        kw.update(causal=False)
    else:
        mp = _mrope_positions(rng, b, s)
        ref_kw.update(rope_kind="mrope", mrope_positions=jnp.asarray(mp))
        kw.update(rope_kind="mrope", mrope_positions=_t(mp))
    want, _ = ref_attn.attention(p, jnp.asarray(x), jnp.asarray(pos),
                                 **ref_kw)
    got, cache = attn_lib.attention(tp, _t(x), _t(pos), **kw)
    assert cache is None
    _close(got.detach(), want)


def test_only_causal_self_attention_reaches_the_flash_kernel(monkeypatch):
    """impl='pallas' routes the causal self-attention to kernel #15 and
    the cross-attention and the encoder's unmasked attention to the plain
    path (repro/models/attention.py:249-252)."""
    called = []
    real = ops.flash_attention

    def spy(*args, **kw):
        called.append(True)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    p = flat_lib.params_from_numpy(jax.tree.map(
        np.asarray, ref_attn.init_attention(jax.random.key(1), 64, 2, 2,
                                            64)))
    x = torch.randn(1, 5, 64)
    pos = torch.arange(5)[None]
    for kw, reaches in ((dict(), True), (dict(causal=False), False),
                        (dict(kv_override=torch.randn(1, 3, 64),
                              causal=False, rope_kind="none"), False)):
        called.clear()
        with torch.inference_mode():
            pallas, _ = attn_lib.attention(p, x, pos, head_dim=64,
                                           impl="pallas", **kw)
            xla, _ = attn_lib.attention(p, x, pos, head_dim=64, **kw)
        assert bool(called) == reaches, kw
        _close(pallas, xla)


# ---------------------------------------------------------------------------
# The encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_encoder_plan_matches_reference(smoke):
    ref_cfg = ref_get_config("seamless-m4t-large-v2")
    cfg = get_config("seamless-m4t-large-v2")
    if smoke:
        ref_cfg, cfg = ref_cfg.smoke(), cfg.smoke()
    assert dataclasses.astuple(transformer.plan_layers(
        cfg, cfg.encoder_layers)) == dataclasses.astuple(
        ref_transformer.plan_layers(ref_cfg, ref_cfg.encoder_layers))


def test_encode_matches_reference_and_is_not_causal(carried):
    """Model.encode against the reference's; the memory at frame 0 moves
    when the last frame does (no causal mask in the encoder)."""
    ref_model, params, model, tparams = carried["seamless-m4t-large-v2"]
    batch = _inputs(model.cfg, 2, 4, seed=3, enc_len=10)
    jb, tb = _both(batch)
    want = ref_model.encode(params, jb)
    with torch.inference_mode():
        got = model.encode(tparams, tb)
        tb["enc_embeds"] = tb["enc_embeds"].clone()
        tb["enc_embeds"][:, -1] += 1.0
        moved = model.encode(tparams, tb)
    _close(got, want)
    assert not torch.allclose(moved[:, 0], got[:, 0])
    assert model.encode(tparams, tb).shape == (2, 10, model.cfg.d_model)
    qwen = carried["qwen2-vl-2b"]
    assert qwen[2].encode(qwen[3], tb) is None


# ---------------------------------------------------------------------------
# The loss's patch mask
# ---------------------------------------------------------------------------


def test_loss_without_patch_embeddings_matches_reference(carried):
    """The patch targets are masked whether or not the batch carries
    frontend_embeds (repro/models/model.py:66-70)."""
    ref_model, params, model, tparams = carried["qwen2-vl-2b"]
    batch = _inputs(model.cfg, 2, 16, seed=4)
    del batch["frontend_embeds"]
    jb, tb = _both(batch)
    ref_loss, ref_grads = jax.jit(ref_model.grad_fn())(params, jb,
                                                        jax.random.key(0))
    loss, grads = model.grad_fn()(tparams, tb)
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    want = np.concatenate([np.ravel(g) for g in jax.tree.leaves(ref_grads)])
    _close(flat_lib.make_flat_spec(tparams).ravel(grads), want, 1e-4)


def test_loss_ignores_the_patch_targets(carried):
    """Tokens 1 .. P-1 are inputs the patch embeddings replace and
    targets the mask drops: changing them leaves the loss as it was;
    token P, an input past the patches, moves it."""
    _, _, model, tparams = carried["qwen2-vl-2b"]
    p = model.cfg.frontend_positions
    _, tb = _both(_inputs(model.cfg, 2, 16, seed=5))
    with torch.inference_mode():
        loss = model.loss(tparams, tb)
        tb["tokens"] = tb["tokens"].clone()
        tb["tokens"][:, 1:p] = (tb["tokens"][:, 1:p] + 1) % \
            model.cfg.vocab_size
        assert torch.equal(model.loss(tparams, tb), loss)
        tb["tokens"][:, p] = (tb["tokens"][:, p] + 1) % model.cfg.vocab_size
        assert not torch.equal(model.loss(tparams, tb), loss)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _enc_out(carried, name, b, seed=9):
    """(reference enc_out, port enc_out) of the same frames, or Nones."""
    ref_model, params, model, tparams = carried[name]
    if not model.cfg.is_encoder_decoder:
        return None, None
    jb, tb = _both(_inputs(model.cfg, b, 4, seed, enc_len=7))
    want = ref_model.encode(params, jb)
    return want, flat_lib.params_from_numpy(np.asarray(want))


def _step_batch(batch, t, lead=0):
    """The one-token batch at step t of a prefill batch."""
    out = {"tokens": batch["tokens"][:, t:t + 1],
           "positions": batch["positions"][:, t:t + 1]}
    if "mrope_positions" in batch:
        out["mrope_positions"] = batch["mrope_positions"][:, :, t:t + 1]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(carried, name):
    """6 steps: the logits and every cache leaf (positions and index
    exactly); Qwen2-VL's steps take three distinct M-RoPE components,
    SeamlessM4T's attend the reference's encoder memory."""
    ref_model, params, model, tparams = carried[name]
    b, steps = 2, 6
    batch = _inputs(model.cfg, b, steps, seed=7)
    batch.pop("frontend_embeds", None)
    ref_enc, enc = _enc_out(carried, name, b)
    ref_caches = ref_model.init_caches(b, 8, dtype=jnp.float32)
    caches = flat_lib.params_from_numpy(jax.tree.map(np.asarray, ref_caches))
    step = jax.jit(lambda p, x, c: ref_model.decode_step(p, x, c,
                                                         enc_out=ref_enc))
    for t in range(steps):
        jb, tb = _both(_step_batch(batch, t))
        want, ref_caches = step(params, jb, ref_caches)
        with torch.inference_mode():
            got, caches = model.decode_step(tparams, tb, caches,
                                            enc_out=enc)
        _close(got, want, msg=f"{name} t={t} logits")
        want_leaves = sorted_leaves(jax.tree.map(np.asarray, ref_caches))
        got_leaves = sorted_leaves(caches)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            if w.dtype == np.int32:
                np.testing.assert_array_equal(g.numpy(), w, str(path))
            else:
                _close(g, w, msg=f"{name} t={t} {path}")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_agreement(carried, name):
    """tests/test_arch_smoke.py::test_prefill_decode_agreement on the
    port: token-by-token decode reproduces the prefill logits (2e-3
    absolute and relative); decode is text only, so Qwen2-VL drops its
    patch prefix (as the reference's test does) and keeps three distinct
    M-RoPE components; SeamlessM4T decodes against the encoder memory
    its prefill computed."""
    _, _, model, tparams = carried[name]
    if model.cfg.frontend == "vision":
        model = build_model(dataclasses.replace(model.cfg, frontend=None))
    b, s = 2, 12
    batch = _inputs(model.cfg, b, s, seed=6)
    _, tb = _both(batch)
    with torch.inference_mode():
        enc = model.encode(tparams, tb)
        full = model.logits(tparams, tb)
        caches = model.init_caches(b, s, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(s):
            lg, caches = model.decode_step(tparams, _step_batch(tb, t),
                                           caches, enc_out=enc)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_generate_tokens_are_the_reference_tokens(carried, name):
    ref_model, params, model, tparams = carried[name]
    prompt = np.random.default_rng(11).integers(
        0, model.cfg.vocab_size, size=(2, 4)).astype(np.int32)
    ref_enc, enc = _enc_out(carried, name, 2)
    want = ref_serve.generate(ref_model, params, jnp.asarray(prompt),
                              max_new_tokens=8, enc_out=ref_enc)
    got = generate(model, tparams, _t(prompt), max_new_tokens=8,
                   enc_out=enc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_personalized_of_qwen2_vl_matches_reference(carried):
    """Greedy, the reference's jit(vmap(decode_step)) with its (B, 3, 1,
    1) M-RoPE positions against the port's torch.func.vmap, from the
    same base and deltas; no op falls back to vmap's per-lane loop."""
    ref_model, params, model, tparams = carried["qwen2-vl-2b"]
    spec = flat_lib.make_flat_spec(tparams)
    base = spec.ravel(tparams)
    ref_spec = ref_flat.make_flat_spec(params)
    deltas = np.random.default_rng(7).standard_normal(
        (2, spec.d), dtype=np.float32) * 0.05
    prompt = np.random.default_rng(13).integers(
        0, model.cfg.vocab_size, size=(2, 3)).astype(np.int32)
    want = ref_serve.generate_personalized(
        ref_model, ref_spec, ref_spec.ravel(params), jnp.asarray(deltas),
        jnp.asarray(prompt), max_new_tokens=5)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            got = generate_personalized(model, spec, base,
                                        torch.from_numpy(deltas),
                                        _t(prompt), max_new_tokens=5)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# One FedDec step (tests/test_arch_smoke.py::TestFedTrainStep)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_one_feddec_step_matches_reference(carried, name):
    """One Algorithm-1 step over 4 agents (ring, Metropolis, H 2, K 2:
    the server fires) on the tree engine, the batch dict vmapped with the
    agent axis first: (n, 3, B, S) M-RoPE positions, (n, B, P, d) patches,
    (n, B, T, d) frames.  The new parameters within 1e-5·max|x| of the
    reference's, the loss within 1e-5, and as in the reference's test:
    finite, and more than half of the leaves moved."""
    ref_model, params, model, tparams = carried[name]
    g = ref_topo.ring_graph(N_AGENTS, k=1)
    ref_step = ref_make_feddec_step(
        RefFedDecConfig(mixing=RefMixing(g, scheme="metropolis"), h=2, k=2),
        ref_model.grad_fn(), lambda t: jnp.asarray(1e-3), donate=False)
    step = feddec.make_feddec_step(
        feddec.FedDecConfig(mixing=MixingDistribution(
            topo.Graph(g.adjacency), scheme="metropolis"), h=2, k=2),
        model.grad_fn(), lambda t: 1e-3, device="cpu")
    # S 16: past the 8 patch positions, whose targets take no loss
    batch = _inputs(model.cfg, 2, 16, seed=12, lead=(N_AGENTS,))
    jb, tb = _both(batch)
    key = jax.random.key(2)
    rstate = ref_init_state(params, N_AGENTS)
    want, rmet = ref_step(rstate, jb, key)
    state = feddec.init_state(tparams, N_AGENTS)
    start = [x.clone() for x in leaves(state.params)]
    state, met = step(state, tb, ReplayTreeDraws(key))
    assert state.step == int(want.step) == 2
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= \
        TOL * abs(float(rmet["loss"]))
    got_leaves = sorted_leaves(state.params)
    want_leaves = sorted_leaves(jax.tree.map(np.asarray, want.params))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g_), (_, w) in zip(got_leaves, want_leaves):
        _close(g_, w, msg=str(path))
    new = leaves(state.params)
    assert all(bool(torch.isfinite(x).all()) for x in new)
    moved = sum(not torch.allclose(a, b) for a, b in zip(start, new))
    assert moved > len(new) // 2, (moved, len(new))


# ---------------------------------------------------------------------------
# launch/specs.py (tests/test_substrate.py::TestInputSpecs)
# ---------------------------------------------------------------------------


def _schema_of(tree):
    return {k: tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2", "mamba2-2.7b"])
def test_train_specs_match_reference(arch):
    """Keys and shapes of the reference's specs; ids int64, embeddings
    the compute dtype; on the meta device."""
    cfg = get_config(arch)
    got = specs.train_batch_specs(cfg, SHAPES["train_4k"], n_agents=16)
    want = ref_specs.train_batch_specs(ref_get_config(arch),
                                       REF_SHAPES["train_4k"], n_agents=16)
    assert _schema_of(got) == _schema_of(want)
    assert got["tokens"].shape == (16, 16, 4096)
    if cfg.rope_kind == "mrope":
        assert got["mrope_positions"].shape == (16, 3, 16, 4096)
    if cfg.frontend == "vision":
        assert got["frontend_embeds"].shape[2] == cfg.frontend_positions
    if cfg.is_encoder_decoder:
        assert got["enc_embeds"].shape == (16, 16, 4096, cfg.d_model)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert v.dtype == (torch.int64 if "embeds" not in k
                           else cfg.compute_dtype), k


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
def test_decode_specs_match_reference(arch):
    got = specs.decode_batch_specs(get_config(arch), SHAPES["decode_32k"])
    want = ref_specs.decode_batch_specs(ref_get_config(arch),
                                        REF_SHAPES["decode_32k"])
    assert _schema_of(got) == _schema_of(want)
    assert got["tokens"].shape == (128, 1)


def test_agent_divisibility_enforced():
    with pytest.raises(AssertionError):
        specs.train_batch_specs(get_config("gemma3-12b"), SHAPES["train_4k"],
                                n_agents=7)


@pytest.mark.parametrize("b,s", [(1, 1), (3, 2), (6, 4), (2, 3)])
def test_concrete_batch_matches_schema(b, s):
    cfg = get_config("qwen1.5-4b").smoke()
    batch = specs.concrete_batch(cfg, None, b, 8 * s, Draws(0, "cpu"))
    assert batch["tokens"].shape == (b, 8 * s)
    assert int(batch["tokens"].max()) < cfg.vocab_size


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_concrete_batch_of_the_pair_matches_reference(name, decode):
    """Keys and shapes of the reference's concrete_batch (agent axis
    first, 8 encoder frames); positions and every M-RoPE component
    0 .. S-1; embeddings finite, ~N(0, 0.02²)."""
    kw = dict(decode=decode, enc_len=8)
    got = specs.concrete_batch(get_config(name).smoke(), 3, 2, 5,
                               Draws(0, "cpu"), **kw)
    want = ref_specs.concrete_batch(ref_get_config(name).smoke(), 3, 2, 5,
                                    jax.random.key(0), **kw)
    assert _schema_of(got) == _schema_of(want)
    for k in ("positions", "mrope_positions"):
        if k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k, v in got.items():
        if v.is_floating_point():
            assert bool(torch.isfinite(v).all()) and \
                0.005 < float(v.std()) < 0.05, k
