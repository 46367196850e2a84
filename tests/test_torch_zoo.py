"""The port's model-zoo prefill against the JAX package's: kernels #15–#17
(flash attention, the SSD scan, the RG-LRU scan) and whole models
(``Model.logits`` with ``impl='xla'`` and ``impl='pallas'``) on the tiny
LM and the smoke configs of ``recurrentgemma-9b``, ``mamba2-2.7b``,
``gemma3-12b`` (GeGLU, a 5:1 local:global interleave cut to 1:1),
``nemotron-4-15b`` (squared ReLU), ``deepseek-v2-lite-16b`` (MLA and
MoE, no kernel under either impl), ``qwen2-vl-2b`` (M-RoPE with three
distinct position components, the stub patch prefix and its loss mask)
and ``seamless-m4t-large-v2`` (the encoder and cross-attention on the
plain path, #15 in the decoder's self-attention), their configs,
parameter counts and layer plans; also the shape table
(``configs.SHAPES``) and ``layers.layer_norm``.

On the CPU the port's kernel wrappers run their plain versions
(kernels/ref.py); the reference runs its Pallas kernels in interpret mode,
as its own tests do.  Inputs are numpy arrays from a seed, handed to
both; the reference's weights cross over through ``params_from_numpy``.
Tolerances, all f32: 1e-5·max|y| per kernel function and 1e-4·max|logit|
per model (other summation orders, the SSD scan token by token against
the reference's chunks, the RG-LRU scan in another log-depth tree).

The parameter trees, the pallas path's launches and gradients, the loss
and grads at f32 and the bf16 bound of ``chip_smoke.py``'s full-model
check are in tests/test_torch_zoo_models.py, which imports this module's
helpers (``_carried``, ``_batch``).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro.models import griffin as ref_griffin
from repro.models import ssm as ref_ssm
from repro.models.transformer import plan_layers as ref_plan_layers
from repro_torch.configs import get_config
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as port_train
from repro_torch.models import build_model, griffin, ssm, transformer
from repro_torch.models import layers as layers_lib
from repro_torch.models.transformer import plan_layers
from repro_torch.tree import sorted_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4
MODELS = ["tiny", "recurrentgemma-9b", "mamba2-2.7b", "gemma3-12b",
          "nemotron-4-15b", "deepseek-v2-lite-16b", "qwen2-vl-2b",
          "seamless-m4t-large-v2", "mistral-large-123b", "deepseek-v3-671b"]
# the models whose forward reaches a kernel under impl='pallas'
KERNEL_MODELS = [m for m in MODELS
                 if m not in ("deepseek-v2-lite-16b", "deepseek-v3-671b")]
SEQ = 64   # past the smoke window of 32; four SSD chunks of 16
ENC_LEN = 24   # encoder frames of the encoder-decoder's batches


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Kernel functions: the port's plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# (B, S, H, KV, hd, window); the reference's tiles need S ≤ 128 or 128 | S
FLASH = [(1, 64, 4, 2, 64, 0), (2, 64, 4, 1, 64, 16), (1, 128, 2, 2, 128, 32),
         (1, 256, 4, 4, 64, 100), (1, 96, 2, 1, 256, 0),
         # Gemma3-12B's GQA 2:1 at hd 256 with a window, Nemotron-4-15B's
         # 6:1 at hd 128
         (1, 128, 4, 2, 256, 32), (1, 64, 6, 1, 128, 0)]


@pytest.mark.parametrize("b,s,h,kv,hd,window", FLASH)
def test_flash_attention_matches_pallas(b, s, h, kv, hd, window):
    rng = np.random.default_rng(s * 31 + hd + window)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    want = np.asarray(ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window))
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    _close(got, want, KERNEL_TOL)
    # and the reference's full-softmax oracle, with P in f32 as well
    _close(got, ref_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window),
        KERNEL_TOL)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    # Δ = softplus(N(0, 1) − 4.6) and A = −(1..H): the model's ranges
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 4.6)).astype(
        np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32)
    bb = rng.standard_normal((b, s, n), dtype=np.float32)
    cc = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, dt, a, bb, cc


# (B, S, H, P, N, chunk)
SSD = [(1, 64, 4, 32, 16, 16), (2, 48, 3, 16, 8, 16), (1, 32, 16, 8, 32, 8)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD)
def test_ssd_scan_matches_pallas(b, s, h, p, n, chunk):
    args = _ssd_inputs(b, s, h, p, n, seed=s + h + n)
    got = ops.ssd_scan(*map(_t, args))
    want, _ = ref_ops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    _close(got, want, KERNEL_TOL)
    seq, _ = ref_ref.ssd_sequential_ref(*map(jnp.asarray, args))
    _close(got, seq, KERNEL_TOL)
    # the plain path, chunked, against the reference's chunked oracle
    y, final = ssm.ssd_chunked(*map(_t, args), chunk=chunk)
    want_y, want_final = ref_ref.ssd_chunked_ref(*map(jnp.asarray, args),
                                                 chunk=chunk)
    _close(y, want_y, KERNEL_TOL)
    _close(final, want_final, KERNEL_TOL)


# (B, S, W): S and W off the reference's 256 tiles, which its wrapper pads
RGLRU = [(1, 70, 300), (2, 256, 256), (1, 5, 3)]


@pytest.mark.parametrize("b,s,w", RGLRU)
def test_rglru_scan_matches_pallas(b, s, w):
    rng = np.random.default_rng(s * w)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    bx = rng.standard_normal((b, s, w), dtype=np.float32)
    want, want_last = ref_ops.rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    h, h_last = ops.rglru_scan(_t(a), _t(bx))
    assert h.dtype == torch.float32 and h_last.shape == (b, w)
    _close(h, want, KERNEL_TOL)
    _close(h_last, want_last, KERNEL_TOL)
    assert torch.equal(h_last, h[:, -1])
    # the plain path's log-depth scan against the associative scan
    h2, last2 = griffin.rglru_scan(_t(a), _t(bx))
    want2, _ = ref_griffin.rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    _close(h2, want2, KERNEL_TOL)
    assert torch.equal(last2, h2[:, -1])


def test_rglru_gates_match_reference():
    cfg = ref_get_config("recurrentgemma-9b").smoke()
    params = ref_griffin.init_rglru_block(jax.random.key(3), cfg.d_model,
                                          cfg.d_ff_rglru)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_ff_rglru), dtype=np.float32)
    want = ref_griffin.rglru_gates(params, jnp.asarray(x))
    got = griffin.rglru_gates(
        flat_lib.params_from_numpy(jax.tree.map(np.asarray, params)), _t(x))
    for g, w in zip(got, want):
        _close(g, w, KERNEL_TOL)


# ---------------------------------------------------------------------------
# The wrappers' contract
# ---------------------------------------------------------------------------


def _small_qkv(dtype=torch.float32, hd=64):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(1, 8, 2, hd, generator=gen).to(dtype)
            for _ in range(3)]


def _small_ssd(dtype=torch.float32):
    x, dt, a, b, c = map(_t, _ssd_inputs(1, 8, 2, 4, 8, seed=0))
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def _small_rglru(dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    return torch.rand(1, 8, 5, generator=gen).to(dtype), \
        torch.randn(1, 8, 5, generator=gen).to(dtype)


CALLS = {
    "flash_attention": lambda dt: ops.flash_attention(*_small_qkv(dt)),
    "ssd_scan": lambda dt: ops.ssd_scan(*_small_ssd(dt)),
    "rglru_scan": lambda dt: ops.rglru_scan(*_small_rglru(dt)),
}


@pytest.mark.parametrize("kernel", sorted(CALLS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_f32_and_bf16(kernel, dtype):
    out = CALLS[kernel](dtype)
    out = out if isinstance(out, tuple) else (out,)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    if kernel != "rglru_scan":
        assert out[0].dtype == dtype
    else:
        assert out[0].dtype == torch.float32


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_wrappers_reject_other_dtypes(kernel):
    with pytest.raises(TypeError):
        CALLS[kernel](torch.float16)


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_wrappers_are_forward_only(kernel):
    args = {"flash_attention": _small_qkv, "ssd_scan": _small_ssd,
            "rglru_scan": _small_rglru}[kernel]()
    args[0].requires_grad_()
    fn = getattr(ops, kernel)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)
    assert getattr(fn, "launches") == 0   # CPU calls launch nothing


def test_flash_attention_rejects_head_dims_without_a_kernel():
    q, k, v = _small_qkv(hd=32)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# Configs, layer plans and parameter trees
# ---------------------------------------------------------------------------


def _configs(name, smoke=True):
    """(reference config, port config) of a model, smoke-sized or full."""
    if name == "tiny":
        if smoke:
            return (ref_train.tiny_lm_config(64, 2, vocab=256),
                    port_train.tiny_lm_config(64, 2, vocab=256))
        return ref_train.tiny_lm_config(), get_config("tiny")
    ref_cfg, cfg = ref_get_config(name), get_config(name)
    return (ref_cfg.smoke(), cfg.smoke()) if smoke else (ref_cfg, cfg)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("jnp.", "")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", MODELS)
def test_config_fields_match_reference(name, smoke):
    ref_cfg, cfg = _configs(name, smoke)
    for field in dataclasses.fields(cfg):
        got, want = getattr(cfg, field.name), getattr(ref_cfg, field.name)
        if field.name.endswith("dtype"):
            assert _dtype_name(got) == jnp.dtype(want).name, field.name
        elif field.name in ("ssm", "moe", "mla") and got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, field.name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", MODELS)
def test_plan_layers_matches_reference(name, smoke):
    ref_cfg, cfg = _configs(name, smoke)
    assert dataclasses.astuple(plan_layers(cfg)) == \
        dataclasses.astuple(ref_plan_layers(ref_cfg))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", MODELS[3:])
def test_param_counts_match_reference(name, smoke):
    ref_cfg, cfg = _configs(name, smoke)
    assert cfg.num_params() == ref_cfg.num_params()
    assert cfg.num_active_params() == ref_cfg.num_active_params()
    for i in range(cfg.num_layers):
        assert cfg._layer_d_ff(i) == ref_cfg._layer_d_ff(i)


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_shapes_match_reference(name):
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro_torch.configs import SHAPES
    got, want = SHAPES[name], REF_SHAPES[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.is_decode, got.needs_subquadratic) == \
        (want.is_decode, want.needs_subquadratic)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    from repro.models import layers as ref_layers
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2, 5, 48)) + 1.5).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == np.float32 else
                (jnp.bfloat16, torch.bfloat16))
    want = ref_layers.layer_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x).astype(jdt))
    got = layers_lib.layer_norm({"scale": _t(scale), "bias": _t(bias)},
                                _t(x).to(tdt))
    assert got.dtype == tdt
    # bf16 output: one rounding of the same f32 value on both sides
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           KERNEL_TOL if dtype == np.float32 else 2.0 ** -8)
    init = layers_lib.init_layer_norm(48, torch.float32, "cpu")
    ref_init = ref_layers.init_layer_norm(48)
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(init[key].numpy(),
                                      np.asarray(ref_init[key]))


def _old_init_dense(draws, shape, dtype, fan_in=None, bias=False):
    """layers.init_dense as it was before the init repair."""
    fan = fan_in if fan_in is not None else shape[0]
    w = draws.truncated_normal(shape) / math.sqrt(fan)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(shape[1:], dtype=dtype, device=draws.device)
    return p


def _old_init_embedding(draws, vocab, d, dtype):
    return {"table": (draws.normal((vocab, d)) * 0.02).to(dtype)}


def _old_init_stack(draws, cfg, num_layers=None, cross=False):
    """transformer._init_stack as it was before the init repair: every
    group's block built, then stacked."""
    plan = plan_layers(cfg, num_layers)
    params = {f"pre_{i}": transformer.init_block(draws, cfg, i, cross)
              for i in range(plan.prefix)}
    if plan.n_groups:
        params["scan"] = {
            f"sub_{j}": tree_map(lambda *a: torch.stack(a), *[
                transformer.init_block(draws, cfg, plan.prefix + j, cross)
                for _ in range(plan.n_groups)])
            for j in range(plan.period)}
    for i in range(plan.suffix):
        li = plan.prefix + plan.period * plan.n_groups + i
        params[f"suf_{i}"] = transformer.init_block(draws, cfg, li, cross)
    return params


@pytest.fixture
def one_thread():
    """The inits below are thousands of small draws: beside the other
    test workers, every intra-op thread pool oversubscribes the cores and
    each small op then waits milliseconds on its pool (one case took 92 s
    where it takes 1 s alone).  The draws do not depend on the count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,layers", [
    ("deepseek-v2-lite-16b", 3), ("gemma3-12b", 4), ("nemotron-4-15b", 2),
    ("recurrentgemma-9b", 3), ("mamba2-2.7b", 2), ("qwen1.5-4b", 2),
    ("seamless-m4t-large-v2", 3)])
def test_init_draws_the_weights_of_the_old_construction(monkeypatch, name,
                                                        layers, one_thread):
    """The stack's init allocates each stacked leaf once and fills it
    group by group, scaling draws in place: the same weights, bit for
    bit, as building every block, stacking them and scaling out of
    place, for every seed (here 0 and 1), scanned groups included."""
    cfg = dataclasses.replace(get_config(name).smoke(), num_layers=layers)
    assert plan_layers(cfg).n_groups >= 2
    model = build_model(cfg)
    new = [model.init(Draws(seed, "cpu")) for seed in (0, 1)]
    monkeypatch.setattr(layers_lib, "init_dense", _old_init_dense)
    monkeypatch.setattr(layers_lib, "init_embedding", _old_init_embedding)
    monkeypatch.setattr(transformer, "_init_stack", _old_init_stack)
    for seed, got in zip((0, 1), new):
        want = model.init(Draws(seed, "cpu"))
        assert [p for p, _ in sorted_leaves(got)] == \
            [p for p, _ in sorted_leaves(want)]
        for (path, g), (_, w) in zip(sorted_leaves(got),
                                     sorted_leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), path


def test_recurrentgemma_plan_is_period_3_with_a_suffix_of_2():
    plan = plan_layers(get_config("recurrentgemma-9b"))
    assert dataclasses.astuple(plan) == (0, 3, 12, 2)
    assert dataclasses.astuple(plan_layers(get_config("mamba2-2.7b"))) == \
        (0, 1, 64, 0)


@functools.lru_cache(maxsize=None)
def _carried(name, seed=0, compute_dtype=None):
    """(reference model, its params, port model, the same params carried
    over), built once per module and read only by the tests."""
    ref_cfg, cfg = _configs(name)
    if compute_dtype is not None:
        ref_cfg = dataclasses.replace(ref_cfg, compute_dtype=compute_dtype[0])
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype[1])
    ref_model = ref_build_model(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.key(seed))
    tparams = flat_lib.params_from_numpy(jax.tree.map(np.asarray, params))
    return ref_model, params, build_model(cfg), tparams


# ---------------------------------------------------------------------------
# Whole models: Model.logits on both paths
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=SEQ, seed=1):
    """(reference batch, port batch) of the same numpy draws for config
    ``cfg`` (either package's): tokens and positions, and the model's
    other inputs: M-RoPE positions with three distinct components (the
    temporal one the sequence position, height and width drawn), stub
    patch embeddings, stub encoder frames."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size,
                                     size=(b, s)).astype(np.int32),
              "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                           (b, s))}
    if cfg.rope_kind == "mrope":
        arrays["mrope_positions"] = np.stack([
            arrays["positions"],
            rng.integers(0, s, size=(b, s)).astype(np.int32),
            rng.integers(0, s, size=(b, s)).astype(np.int32)])
    if cfg.frontend == "vision":
        arrays["frontend_embeds"] = 0.02 * rng.standard_normal(
            (b, cfg.frontend_positions, cfg.d_model), dtype=np.float32)
    if cfg.is_encoder_decoder:
        arrays["enc_embeds"] = 0.02 * rng.standard_normal(
            (b, ENC_LEN, cfg.d_model), dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(np.ascontiguousarray(
                v.astype(np.int64) if v.dtype == np.int32 else v))
             for k, v in arrays.items()})


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", MODELS)
def test_logits_match_reference(name, impl):
    ref_model, params, model, tparams = _carried(name)
    jbatch, tbatch = _batch(ref_model.cfg)
    want, _ = ref_model.logits(params, jbatch, impl=impl)
    with torch.inference_mode():
        got = model.logits(tparams, tbatch, impl=impl)
    _close(got, want, MODEL_TOL)


def _ssd_exact(args):
    """The SSD recurrence in f64 (B, S, H, P), the accuracy checks' truth."""
    x, dt, a, b, c = (t.double() for t in args)
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], b.shape[-1],
                        dtype=torch.float64)
    exact = []
    for t in range(x.shape[1]):
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + \
            (x[:, t] * dt[:, t, :, None])[..., None] * b[:, t][:, None, None, :]
        exact.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(exact, dim=1)


def test_ssd_recurrence_is_more_accurate_than_the_chunked_form():
    """Why the plain version of kernel #16 runs the token recurrence, and
    why the kernel's chunked form takes its decays from direct segment sums:
    at Mamba2's largest heads (A = −77 … −80) and its Δ range, the
    reference's cumulative log-decays reach −200 inside a 256-token chunk
    and their f32 differences exp(cum_i − cum_j) lose digits.  Against an
    f64 recurrence that chunked scan errs about 1e-5·max|y|, the f32
    recurrence about 1e-7."""
    x, dt, _, b, c = _ssd_inputs(1, 512, 4, 64, 128, seed=11)
    a = -np.arange(77, 81, dtype=np.float32)
    args = [_t(v) for v in (x, dt, a, b, c)]
    exact = _ssd_exact(args)
    scale = exact.abs().max().item()
    rec_err = (ref.ssd_scan_ref(*args).double() - exact).abs().max().item()
    chunk_err = (ssm.ssd_chunked(*args, chunk=256)[0].double()
                 - exact).abs().max().item()
    assert rec_err <= 1e-6 * scale
    assert chunk_err >= 10 * rec_err


def _split_product(eq, exact, other, split):
    """einsum(eq, exact, other) in f32; with ``split``, as kernel #16's bf16
    route forms it on the tensor cores: the f32 operand ``other`` as its
    bf16 pieces hi = bf16(other) and lo = bf16(other − hi), one product
    each, summed in f32 (``exact`` holds bf16 values)."""
    if not split:
        return torch.einsum(eq, exact, other)
    hi = other.bfloat16().float()
    lo = (other - hi).bfloat16().float()
    return torch.einsum(eq, exact, hi) + torch.einsum(eq, exact, lo)


def _ssd_kernel_emulation(x, dt, a, b, c, chunk, split=False):
    """Kernel #16's arithmetic in torch f32 (test code, never called by the
    package): chunks of ``chunk`` tokens (S need not be a multiple), every
    decay from a direct segment sum of la = Δ·A, never a difference of two
    cumulative sums: s⁺_j = Σ_{k>j} la_k summed from the chunk's end;
    seg[i, j] = Σ_{j<k≤i} la_k built along i from j + 1; cum_i = Σ_{k≤i}
    la_k from the chunk's start.  Pass 1: each chunk's own state
    Σ_j x_j ⊗ B_j·exp(s⁺_j)·Δ_j and exp(Σ la); pass 2: the recurrence over
    chunks in f32; pass 3: y_i = exp(cum_i)·C_i·S_{c−1} + Σ_{j≤i}
    (C_i·B_j)·exp(seg[i, j])·Δ_j·x_j.  ``split`` emulates the bf16 route:
    x, B and C exact, the f32 operand of each product as bf16 hi + lo."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t, *tail):
        t = torch.nn.functional.pad(t.float(), (0, 0) * len(tail) + (0, pad))
        return t.reshape(bs, nc, chunk, *tail)

    xs, dts = chunks(x, h, p), chunks(dt, h)
    bb, cc = chunks(b, n), chunks(c, n)
    la = dts * a.float()                                    # (B,NC,L,H)
    suf = torch.flip(torch.cumsum(torch.flip(la, [2]), 2), [2])
    s_plus = torch.cat([suf[:, :, 1:], torch.zeros_like(suf[:, :, :1])], 2)
    bw = bb[:, :, :, None, :] * (torch.exp(s_plus) * dts)[..., None]
    local = _split_product("bnjhp,bnjhd->bnhpd", xs, bw, split)
    decay = torch.exp(suf[:, :, 0])                         # (B,NC,H)
    state = torch.zeros(bs, h, p, n)
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * decay[:, i, :, None, None] + local[:, i]
    prev = torch.stack(prev, dim=1)                         # (B,NC,H,P,N)
    seg = torch.zeros(bs, nc, chunk, chunk, h)              # [i, j]
    for j in range(chunk - 1):
        seg[:, :, j + 1:, j] = torch.cumsum(la[:, :, j + 1:], 2)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    g = torch.einsum("bnid,bnjd->bnij", cc, bb)[..., None] * torch.where(
        mask[None, None, :, :, None], torch.exp(seg) * dts[:, :, None],
        torch.zeros(()))
    y = torch.exp(torch.cumsum(la, 2))[..., None] * _split_product(
        "bnid,bnhpd->bnihp", cc, prev, split)
    y = y + _split_product("bnjhp,bnijh->bnihp", xs, g, split)
    return y.reshape(bs, nc * chunk, h, p)[:, :s].to(x.dtype)


@pytest.mark.parametrize("s", [512, 500])
def test_ssd_kernel_arithmetic_keeps_the_recurrence_accuracy(s):
    """Kernel #16's chunked form with direct segment sums, on the inputs
    where the reference's cum-difference form errs 1e-5·max|y| (A = −77 …
    −80): the f32 route (64-token chunks) stays within 1e-6·max|y| of the
    f64 recurrence (the chip's accuracy check) and the cum-difference form
    errs at least 10× more; the bf16 route (128-token chunks, x, B, C in
    bf16, each f32 operand split into hi + lo) within KERNEL_TOL of the
    recurrence on the same inputs."""
    x, dt, _, b, c = _ssd_inputs(1, s, 4, 64, 128, seed=11)
    a = -np.arange(77, 81, dtype=np.float32)
    args = [_t(v) for v in (x, dt, a, b, c)]
    exact = _ssd_exact(args)
    scale = exact.abs().max().item()
    err = (_ssd_kernel_emulation(*args, chunk=64).double()
           - exact).abs().max().item()
    assert err <= 1e-6 * scale
    if s % 256 == 0:
        chunk_err = (ssm.ssd_chunked(*args, chunk=256)[0].double()
                     - exact).abs().max().item()
        assert chunk_err >= 10 * err
    rounded = [_t(_bf16(v)) if i in (0, 3, 4) else _t(v)
               for i, v in enumerate((x, dt, a, b, c))]
    exact = _ssd_exact(rounded)
    split = _ssd_kernel_emulation(*rounded, chunk=128, split=True)
    assert (split.double() - exact).abs().max().item() <= \
        KERNEL_TOL * exact.abs().max().item()


# (B, S, H, P, N, the reference's chunk, the emulation's chunk): S off the
# emulation's chunk (64 off 48, 48 off 32) and below it (32 < 64)
SSD_EMULATED = [(1, 64, 4, 32, 16, 16, 48), (2, 48, 3, 16, 8, 16, 32),
                (1, 32, 16, 8, 32, 8, 64)]


@pytest.mark.parametrize("split", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,emulated", SSD_EMULATED)
def test_ssd_kernel_arithmetic_matches_pallas(b, s, h, p, n, chunk, emulated,
                                              split):
    """The emulation of kernel #16 against the reference's Pallas kernel
    (interpret mode) at KERNEL_TOL; the bf16 route on bf16-valued x, B, C
    handed to both."""
    args = list(_ssd_inputs(b, s, h, p, n, seed=s + h + n))
    if split:
        args = [_bf16(v) if i in (0, 3, 4) else v for i, v in enumerate(args)]
    want, _ = ref_ops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    got = _ssd_kernel_emulation(*map(_t, args), chunk=emulated, split=split)
    _close(got, want, KERNEL_TOL)


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 → bf16 (round to nearest even) → f32, in numpy: the top 16 bits
    of the f32 pattern after the rounding bias."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def test_split_p_product_keeps_f32_accuracy():
    """#15's bf16 kernel forms P·V on the tensor cores as P_hi·V + P_lo·V,
    with P_hi = bf16(P), P_lo = bf16(P − P_hi) and V in bf16, accumulated
    in f32.  At RecurrentGemma-9B's head shape (hd 256, a 2048-key window,
    64 query rows) that stays within 2^-16·Σ|p||v| of the f64 product of
    the f32 P with V; one bf16 product (the xla path's P) does not."""
    rng = np.random.default_rng(0)
    rows, keys, hd = 64, 2048, 256
    scores = rng.standard_normal((rows, keys)) * 3.0
    p = np.exp(scores - scores.max(axis=1, keepdims=True))
    p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    v = _bf16(rng.standard_normal((keys, hd)).astype(np.float32))
    assert np.array_equal(_bf16(p), torch.from_numpy(p).bfloat16().float()
                          .numpy())
    p_hi = _bf16(p)
    p_lo = _bf16(p - p_hi)
    split = p_hi @ v + p_lo @ v              # f32 accumulation
    exact = p.astype(np.float64) @ v.astype(np.float64)
    bound = 2.0 ** -16 * (np.abs(p).astype(np.float64) @ np.abs(v))
    assert np.all(np.abs(split - exact) <= bound)
    one = p_hi @ v
    assert np.abs(one - exact).max() > 16 * bound.max()


def test_ssd_chunked_backward_is_finite_where_the_masked_decay_overflows():
    """Above the diagonal, cum_i − cum_j = Σ Δ·|A| overflows exp at a
    128-token chunk and |A| up to 80 (Mamba2-2.7B's heads).  The
    reference masks after the exp, so its gradients of Δ and A are NaN
    there; the port masks before it: the same forward (within
    1e-5·max|y| of the reference's, the zoo's f32 rule), and gradients
    within 1e-4·max|g| of the token recurrence's (kernels/ref.py:
    ssd_scan_ref's arithmetic, written out of place for autograd)."""
    rng = np.random.default_rng(0)
    shape_b, s, h, p, n = 1, 128, 8, 4, 8
    args = [rng.standard_normal((shape_b, s, h, p)).astype(np.float32),
            np.full((shape_b, s, h), 0.1, np.float32),
            -10.0 * np.arange(1, h + 1, dtype=np.float32),
            rng.standard_normal((shape_b, s, n)).astype(np.float32),
            rng.standard_normal((shape_b, s, n)).astype(np.float32)]
    w = rng.standard_normal((shape_b, s, h, p)).astype(np.float32)

    def ref_loss(*a):
        return jnp.sum(ref_ssm.ssd_chunked(*a, chunk=s)[0] * w)

    ref_grads = jax.grad(ref_loss, argnums=(1, 2))(*map(jnp.asarray, args))
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_grads)

    def port_grads(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        y = fn(*ts)
        (y * torch.from_numpy(w)).sum().backward()
        return y.detach(), [t.grad for t in ts]

    y, got = port_grads(lambda *t: ssm.ssd_chunked(*t, chunk=s)[0])
    want_y = np.asarray(ref_ssm.ssd_chunked(*map(jnp.asarray, args),
                                            chunk=s)[0])
    assert np.abs(y.numpy() - want_y).max() <= 1e-5 * np.abs(want_y).max()
    def recurrence(x, dt, a, b, c):   # ssd_scan_ref's, out of place
        decay, xl = torch.exp(dt * a), x * dt[..., None]
        state = torch.zeros(shape_b, h, p, n)
        ys = []
        for t in range(s):
            state = state * decay[:, t, :, None, None] \
                + xl[:, t, :, :, None] * b[:, t, None, None, :]
            ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
        return torch.stack(ys, dim=1)

    _, want = port_grads(recurrence)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max() <= 1e-4 * r.abs().max()
