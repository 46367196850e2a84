"""The port's serving module (repro_torch.launch.serve) against the JAX
package's (repro.launch.serve): the ``generate`` contract, greedy and
temperature decode, and the multi-tenant personalized decode, on
Qwen1.5-4B's smoke config (the reference CLI's default model) with the
reference's weights carried as numpy.

Mirrors 15 of the 16 tests of tests/test_serve.py.  The one left out,
``test_compiled_step_reused_across_calls``, checks the reference's
per-(model, long_variant) cache of its ``jax.jit``-compiled decode step;
eager PyTorch compiles nothing, so the port has no such cache to reuse
(launch/serve.py).  Added: greedy ``generate`` and
``generate_personalized`` give the reference's tokens, temperature
sampling under the reference's Gumbel noise, replayed through the port's
``Draws``, gives its tokens, and the CLI runs on the CPU and serves a
training checkpoint's agent 0.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import flat as ref_flat
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.core import flat as flat_lib
from repro_torch.core.draws import Draws
from repro_torch.launch import serve
from repro_torch.launch import train as port_train
from repro_torch.launch.serve import generate, generate_personalized
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_config("qwen1.5-4b").smoke()
    ref_model = ref_build_model(ref_get_config("qwen1.5-4b").smoke())
    ref_params = jax.jit(ref_model.init)(jax.random.key(0))
    params = flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                     ref_params))
    return cfg, build_model(cfg), params, ref_model, ref_params


def _prompt(cfg, b=2, s=4, seed=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)))


class TestValidation:
    def test_prompt_must_be_2d(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        with pytest.raises(ValueError, match=r"\(B, S_prompt\)"):
            generate(model, params, torch.zeros(4, dtype=torch.long))
        with pytest.raises(ValueError, match=r"\(B, S_prompt\)"):
            generate(model, params, torch.zeros((2, 3, 4), dtype=torch.long))

    def test_max_new_tokens_positive(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        with pytest.raises(ValueError, match="max_new_tokens"):
            generate(model, params, _prompt(cfg), max_new_tokens=0)

    def test_temperature_nonnegative(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        with pytest.raises(ValueError, match="temperature"):
            generate(model, params, _prompt(cfg), temperature=-0.5)

    def test_nonempty_prompt(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        with pytest.raises(ValueError, match="at least one token"):
            generate(model, params, torch.zeros((2, 0), dtype=torch.long))

    def test_cache_len_must_hold_sequence(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        with pytest.raises(ValueError, match="cannot hold"):
            generate(model, params, _prompt(cfg, s=4), max_new_tokens=8,
                     cache_len=11)

    def test_messages_are_the_reference_messages(self, smoke_model):
        cfg, model, params, ref_model, ref_params = smoke_model
        for prompt, kw in (((2, 3, 4), {}), ((2, 4), {"max_new_tokens": 0}),
                           ((2, 4), {"temperature": -0.5}), ((2, 0), {}),
                           ((2, 4), {"max_new_tokens": 8, "cache_len": 11})):
            with pytest.raises(ValueError) as want:
                ref_serve.generate(ref_model, ref_params,
                                   jnp.zeros(prompt, jnp.int32), **kw)
            with pytest.raises(ValueError) as got:
                generate(model, params, torch.zeros(prompt, dtype=torch.long),
                         **kw)
            assert str(got.value) == str(want.value)


class TestDecode:
    def test_greedy_decode_shape_and_prompt_prefix(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        prompt = _prompt(cfg, b=2, s=4)
        seqs = generate(model, params, prompt, max_new_tokens=3)
        assert seqs.shape == (2, 7)
        assert torch.equal(seqs[:, :4], prompt)
        assert ((seqs >= 0) & (seqs < cfg.vocab_size)).all()

    def test_greedy_is_deterministic(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        prompt = _prompt(cfg, b=1, s=3)
        a = generate(model, params, prompt, max_new_tokens=2)
        b = generate(model, params, prompt, max_new_tokens=2)
        assert torch.equal(a, b)

    def test_explicit_cache_len_matches_default(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        prompt = _prompt(cfg, b=1, s=3)
        a = generate(model, params, prompt, max_new_tokens=2)
        b = generate(model, params, prompt, max_new_tokens=2, cache_len=16)
        assert torch.equal(a, b)

    def test_temperature_sampling_runs(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        seqs = generate(model, params, _prompt(cfg, b=1, s=3),
                        max_new_tokens=2, temperature=1.0,
                        draws=Draws(9, "cpu"))
        assert seqs.shape == (1, 5)

    @pytest.mark.parametrize("long_variant", [False, True])
    def test_greedy_tokens_are_the_reference_tokens(self, smoke_model,
                                                    long_variant):
        """8 new tokens after a 4-token prompt; ``long_variant`` decodes
        with the 64-token window."""
        cfg, model, params, ref_model, ref_params = smoke_model
        prompt = _prompt(cfg, b=2, s=4, seed=11)
        want = ref_serve.generate(ref_model, ref_params,
                                  jnp.asarray(prompt.numpy()),
                                  max_new_tokens=8, long_variant=long_variant)
        got = generate(model, params, prompt, max_new_tokens=8,
                       long_variant=long_variant)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_temperature_tokens_are_the_reference_tokens(self, smoke_model):
        """jax.random.categorical is argmax(logits + Gumbel noise) with the
        noise −log(−log u), u ~ U[tiny, 1) from one split of the key per
        token; Draws.categorical takes the same u from ``uniform``."""
        cfg, model, params, ref_model, ref_params = smoke_model
        prompt = _prompt(cfg, b=2, s=3, seed=12)
        want = ref_serve.generate(ref_model, ref_params,
                                  jnp.asarray(prompt.numpy()),
                                  max_new_tokens=6, temperature=0.7,
                                  key=jax.random.key(9))
        got = generate(model, params, prompt, max_new_tokens=6,
                       temperature=0.7, draws=ReplayGumbelDraws(9))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = generate(model, params, prompt, max_new_tokens=6)
        assert not torch.equal(got, greedy)   # the noise did something


class ReplayGumbelDraws(Draws):
    """The reference generate's sampling noise: ``key, k = split(key)``
    per token, then ``gumbel(k)``'s uniforms on [tiny, 1)."""

    def __init__(self, seed: int):
        super().__init__(seed, "cpu")
        self.key = jax.random.key(seed)

    def uniform(self, shape, dtype=torch.float32):
        assert dtype == torch.float32
        self.key, k = jax.random.split(self.key)
        u = jax.random.uniform(k, shape, jnp.float32,
                               minval=jnp.finfo(jnp.float32).tiny, maxval=1.)
        return torch.from_numpy(np.array(u))


class TestPersonalized:
    @pytest.fixture(scope="class")
    def flat(self, smoke_model):
        cfg, model, params, *_ = smoke_model
        spec = flat_lib.make_flat_spec(params)
        return spec, spec.ravel(params)

    def test_zero_delta_matches_shared_generate(self, smoke_model, flat):
        """delta_rows=None serves the bare base to every request: exactly
        what the shared-params path decodes."""
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        prompt = _prompt(cfg, b=2, s=3)
        shared = generate(model, params, prompt, max_new_tokens=3)
        personalized = generate_personalized(model, spec, base, None,
                                             prompt, max_new_tokens=3)
        assert torch.equal(personalized, shared)

    def test_matches_naive_per_request_loop(self, smoke_model, flat):
        """One vmapped decode per token == B sequential generate calls
        with per-request full parameter sets, token for token."""
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        b = 3
        deltas = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (b, spec.d), dtype=np.float32) * 0.01)
        prompt = _prompt(cfg, b=b, s=3)
        batched = generate_personalized(model, spec, base, deltas, prompt,
                                        max_new_tokens=3)
        for i in range(b):
            p_i = spec.unravel(base + deltas[i])
            naive = generate(model, p_i, prompt[i:i + 1], max_new_tokens=3)
            assert torch.equal(batched[i:i + 1], naive)

    def test_deltas_actually_personalize(self, smoke_model, flat):
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        deltas = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (2, spec.d), dtype=np.float32) * 0.5)
        prompt = _prompt(cfg, b=2, s=3)
        with_d = generate_personalized(model, spec, base, deltas, prompt,
                                       max_new_tokens=4)
        without = generate_personalized(model, spec, base, None, prompt,
                                        max_new_tokens=4)
        assert not torch.equal(with_d, without)

    def test_base_width_checked(self, smoke_model, flat):
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        with pytest.raises(ValueError, match="flat spec"):
            generate_personalized(model, spec, base[:-1], None,
                                  _prompt(cfg, b=1, s=2), max_new_tokens=1)

    def test_delta_rows_shape_checked(self, smoke_model, flat):
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        bad = torch.zeros((3, spec.d))       # B mismatch: prompt has B=2
        with pytest.raises(ValueError, match=r"\(B, D\)"):
            generate_personalized(model, spec, base, bad,
                                  _prompt(cfg, b=2, s=2), max_new_tokens=1)

    def test_prompt_contract_shared_with_generate(self, smoke_model, flat):
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        with pytest.raises(ValueError, match="max_new_tokens"):
            generate_personalized(model, spec, base, None,
                                  _prompt(cfg, b=1, s=2), max_new_tokens=0)

    def test_tokens_are_the_reference_tokens(self, smoke_model, flat):
        """Greedy and sampled, the reference's jit(vmap(decode_step))
        against the port's torch.func.vmap, from the same base and
        deltas."""
        cfg, model, params, ref_model, ref_params = smoke_model
        spec, base = flat
        ref_spec = ref_flat.make_flat_spec(ref_params)
        ref_base = ref_spec.ravel(ref_params)
        np.testing.assert_array_equal(np.asarray(ref_base), base.numpy())
        deltas = np.random.default_rng(7).standard_normal(
            (2, spec.d), dtype=np.float32) * 0.05
        prompt = _prompt(cfg, b=2, s=3, seed=13)
        for temperature in (0.0, 0.7):
            want = ref_serve.generate_personalized(
                ref_model, ref_spec, ref_base, jnp.asarray(deltas),
                jnp.asarray(prompt.numpy()), max_new_tokens=5,
                temperature=temperature, key=jax.random.key(3))
            got = generate_personalized(
                model, spec, base, torch.from_numpy(deltas), prompt,
                max_new_tokens=5, temperature=temperature,
                draws=ReplayGumbelDraws(3))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_vmapped_step_has_a_batching_rule_for_every_op(self, smoke_model,
                                                          flat):
        """vmap falls back to a per-lane loop, with a warning, for an op
        without a batching rule; the personalized step must not (the
        guard of tests/test_torch_batched_grads.py, warning as error)."""
        cfg, model, params, *_ = smoke_model
        spec, base = flat
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("error",
                                        message=".*performance drop.*")
                generate_personalized(model, spec, base, None,
                                      _prompt(cfg, b=2, s=2),
                                      max_new_tokens=2)
        finally:
            torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_cli_serves_on_the_cpu_and_a_training_checkpoint(tmp_path, capsys):
    """The reference's CLI lines; ``--ckpt`` serves agent 0 of a
    ``--ckpt-dir`` run of the training CLI, which must equal generate on
    that agent's parameters."""
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "3",
                "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "[serve] qwen1.5-4b-smoke: 2×2 new tokens in " in out
    assert "[serve] sample: [" in out
    port_train.main(["--device", "cpu", "--arch", "qwen1.5-4b", "--smoke",
                     "--steps", "2", "--agents", "3", "--batch", "1",
                     "--seq", "8", "--h", "2", "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "3",
                "--new-tokens", "2", "--ckpt", str(tmp_path)])
    sample = capsys.readouterr().out.splitlines()[-1]
    params = serve.load_agent_params(str(tmp_path), 0, "cpu")
    cfg = get_config("qwen1.5-4b").smoke()
    prompt = torch.randint(0, cfg.vocab_size, (2, 3),
                           generator=Draws(2, "cpu").generator)
    seqs = generate(build_model(cfg), params, prompt, max_new_tokens=2)
    assert sample == f"[serve] sample: {seqs[0].tolist()}"


@pytest.mark.parametrize("arch", ["mistral-large-123b", "deepseek-v3-671b"])
def test_cli_serves_the_bf16_configs_smoke_variants(capsys, arch):
    """--arch mistral-large-123b and deepseek-v3-671b serve their smoke
    variants on the CPU with the reference's CLI lines."""
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "3", "--new-tokens", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith(f"[serve] {arch}-smoke: 2×2 new tokens in ")
    assert out[-1].startswith("[serve] sample: [")
