"""Serving for the port (repro/launch/serve.py): prefill and greedy
or temperature decode with KV/state caches.

Builds the model, runs the prompt through the caches token by token (the
same cache state a chunked prefill would give), then decodes new tokens
one step at a time.  Works for every ported architecture, including the
recurrent ones whose caches are O(1) in sequence length.  An M-RoPE
model (Qwen2-VL) decodes text only, all three position components at
the token's position; an encoder-decoder model (SeamlessM4T) attends an
encoder memory ``enc_out`` from ``Model.encode`` (the CLI encodes 8 stub
frames, as the reference's does).

Two entry points:

  * :func:`generate` — one parameter set for the whole batch.
  * :func:`generate_personalized` — multi-tenant FedDec serving: request
    b serves agent b, whose weights are ``base + delta_b`` (the delta
    parameterization of core/delta.py).  The (B, D) rows are unflattened
    once into per-leaf views with a leading request axis, and each token
    is ONE ``torch.func.vmap``-ped decode step over the requests, where
    the naive alternative is one ``generate`` per request.

The reference caches its jitted decode step per (model, long_variant);
eager PyTorch has nothing to compile, so there is no such cache here.
Temperature sampling takes a :class:`~repro_torch.core.draws.Draws` where
the reference takes a key: ``Draws.categorical`` is Gumbel-max, as
``jax.random.categorical`` is.

CLI (``--device cuda`` by default; ``--device cpu`` for the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen1.5-4b]
      (or gemma3-12b, mamba2-2.7b, deepseek-v2-lite-16b,
      recurrentgemma-9b, nemotron-4-15b, qwen2-vl-2b,
      seamless-m4t-large-v2, tiny)
      [--batch 4 --prompt-len 16 --new-tokens 32] [--ckpt DIR]
As in the reference, ``--smoke`` defaults to on and cannot be turned off,
so the CLI always serves the config's smoke variant; ``--ckpt DIR``
serves agent 0's slice of a training checkpoint (launch/train.py
``--ckpt-dir``; needs msgpack and zstandard).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_NAMES, NOT_PORTED_ARCHS, get_config
from repro_torch.core.draws import Draws
from repro_torch.launch.specs import concrete_batch
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.tree import tree_map

__all__ = ["generate", "generate_personalized", "load_agent_params",
           "main"]


def _validate_prompt(prompt_tokens, max_new_tokens, temperature, cache_len):
    if prompt_tokens.ndim != 2:
        raise ValueError(
            f"prompt_tokens must be (B, S_prompt), got shape "
            f"{tuple(prompt_tokens.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    b, s_prompt = prompt_tokens.shape
    if s_prompt < 1:
        raise ValueError("prompt must contain at least one token")
    total = s_prompt + max_new_tokens
    if cache_len is None:
        cache_len = total
    elif cache_len < total:
        raise ValueError(
            f"cache_len={cache_len} cannot hold prompt ({s_prompt}) + "
            f"max_new_tokens ({max_new_tokens}) = {total} positions")
    return b, s_prompt, cache_len


def _decode_loop(one, prompt_tokens, max_new_tokens, temperature, draws):
    """The prompt token by token through ``one(tok, pos)`` (which returns
    the last logits (B, 1, V)), then ``max_new_tokens`` sampled tokens:
    argmax at temperature 0, else Gumbel-max on logits / temperature."""
    s_prompt = prompt_tokens.shape[1]
    logits = None
    for t in range(s_prompt):
        logits = one(prompt_tokens[:, t:t + 1], t)
    if draws is None:
        draws = Draws(0, prompt_tokens.device)
    out = [prompt_tokens]
    for i in range(max_new_tokens):
        if temperature > 0:
            tok = draws.categorical(logits[:, -1] / temperature)[:, None]
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
        logits = one(tok, s_prompt + i)
    return torch.cat(out, dim=1)


def generate(model, params, prompt_tokens: torch.Tensor, *,
             max_new_tokens: int = 32, cache_len: int | None = None,
             enc_out=None, long_variant: bool = False,
             temperature: float = 0.0, draws: Draws | None = None):
    """Greedy/temperature decode of prompt_tokens (B, S_prompt) on their
    device (the parameters' too); returns (B, S_prompt + max_new_tokens).
    ``draws`` (default ``Draws(0)`` on that device) samples at
    temperature > 0."""
    b, _, cache_len = _validate_prompt(prompt_tokens, max_new_tokens,
                                       temperature, cache_len)
    device = prompt_tokens.device
    caches = model.init_caches(b, cache_len, long_variant=long_variant,
                               dtype=torch.float32, device=device)

    def one(tok, pos):
        nonlocal caches
        batch = {"tokens": tok,
                 "positions": torch.full((b, 1), pos, device=device)}
        if model.cfg.rope_kind == "mrope":
            batch["mrope_positions"] = torch.full((3, b, 1), pos,
                                                  device=device)
        logits, caches = model.decode_step(params, batch, caches,
                                           enc_out=enc_out,
                                           long_variant=long_variant)
        return logits

    with torch.inference_mode():
        return _decode_loop(one, prompt_tokens, max_new_tokens, temperature,
                            draws)


def generate_personalized(model, flat_spec, base_row: torch.Tensor,
                          delta_rows: torch.Tensor | None,
                          prompt_tokens: torch.Tensor, *,
                          max_new_tokens: int = 32,
                          cache_len: int | None = None,
                          long_variant: bool = False,
                          temperature: float = 0.0,
                          draws: Draws | None = None):
    """Multi-tenant decode: request b serves weights ``base + delta_b``.

    ``flat_spec`` is the model's FlatSpec (core/flat.py:make_flat_spec),
    ``base_row`` the shared (D,) base and ``delta_rows`` the (B, D) dense
    per-request deltas (``None`` serves the bare base to every request).
    The per-request parameters are one (B, D) add and an unflatten into
    views; each decoded token is one ``torch.func.vmap`` of
    ``decode_step`` over the request axis, each lane a batch-1 decode of
    its own agent.  Decoder-only, as the reference's.
    """
    b, _, cache_len = _validate_prompt(prompt_tokens, max_new_tokens,
                                       temperature, cache_len)
    base_row = base_row.reshape(-1)
    if base_row.shape[0] != flat_spec.d:
        raise ValueError(f"base_row has D={base_row.shape[0]}, flat spec "
                         f"has D={flat_spec.d}")
    if delta_rows is not None and tuple(delta_rows.shape) != (b,
                                                              flat_spec.d):
        raise ValueError(
            f"delta_rows must be (B, D) = ({b}, {flat_spec.d}), got "
            f"{tuple(delta_rows.shape)}")
    device = prompt_tokens.device
    with torch.inference_mode():
        rows = base_row[None].expand(b, -1) if delta_rows is None \
            else base_row[None] + delta_rows
        params = flat_spec.unflatten(rows)   # leaves carry the request axis
        caches = tree_map(
            lambda c: c.expand((b,) + c.shape),
            model.init_caches(1, cache_len, long_variant=long_variant,
                              dtype=torch.float32, device=device))
        step = torch.func.vmap(lambda p, x, c: model.decode_step(
            p, x, c, long_variant=long_variant))

        def one(tok, pos):
            nonlocal caches
            batch = {"tokens": tok[:, None, :],
                     "positions": torch.full((b, 1, 1), pos, device=device)}
            if model.cfg.rope_kind == "mrope":
                batch["mrope_positions"] = torch.full((b, 3, 1, 1), pos,
                                                      device=device)
            logits, caches = step(params, batch, caches)   # (B, 1, 1, V)
            return logits[:, 0]

        return _decode_loop(one, prompt_tokens, max_new_tokens, temperature,
                            draws)


def load_agent_params(ckpt_dir: str, agent: int = 0, device="cuda") -> dict:
    """One agent's slice of a training checkpoint's stacked params (the
    latest step), on ``device``."""
    tree = load_checkpoint(ckpt_dir)
    return tree_map(lambda x: x[agent].to(device), tree["params"])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="qwen1.5-4b",
                   help=f"a ported config: {', '.join(ARCH_NAMES)} (not "
                        f"ported yet: {', '.join(NOT_PORTED_ARCHS)})")
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir from launch/train.py")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.arch not in ARCH_NAMES:
        p.error(f"not ported to repro_torch yet: --arch {args.arch} "
                f"(ported: {', '.join(ARCH_NAMES)}; not yet: "
                f"{', '.join(NOT_PORTED_ARCHS)})")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(Draws(0, device))
    if args.ckpt:
        # serve the agent-0 slice of the federated stacked params
        params = load_agent_params(args.ckpt, 0, device)

    enc_out = None
    if cfg.is_encoder_decoder:
        enc_batch = concrete_batch(cfg, None, args.batch, 8,
                                   Draws(1, device), enc_len=8)
        with torch.inference_mode():
            enc_out = model.encode(params, enc_batch)

    prompt = torch.randint(0, cfg.vocab_size,
                           (args.batch, args.prompt_len),
                           generator=Draws(2, device).generator,
                           device=device)
    t0 = time.time()
    seqs = generate(model, params, prompt, max_new_tokens=args.new_tokens,
                    enc_out=enc_out, temperature=args.temperature)
    seqs = seqs.cpu()   # waits for the device
    dt = time.time() - t0
    tput = args.batch * args.new_tokens / dt
    print(f"[serve] {cfg.name}: {args.batch}×{args.new_tokens} new tokens "
          f"in {dt:.1f}s ({tput:.1f} tok/s)")
    print("[serve] sample:", seqs[0, :24].tolist())


if __name__ == "__main__":
    main()
