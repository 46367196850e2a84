"""The batch schema of every model input (repro/launch/specs.py).

``batch_schema`` gives each input's (shape, dtype); ``train_batch_specs``
and ``decode_batch_specs`` give the same inputs as tensors on the meta
device (shapes and dtypes, no storage), where the reference gives
``ShapeDtypeStruct``s; ``concrete_batch`` builds small real batches from
the same schema.  Token, position and M-RoPE position ids are int64, the
port's index dtype (the reference's are int32); embeddings take the
config's compute dtype.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig

__all__ = ["train_batch_specs", "decode_batch_specs", "concrete_batch",
           "batch_schema"]


def batch_schema(cfg: ArchConfig, n_agents: int | None, batch: int,
                 seq: int, *, decode: bool = False,
                 enc_len: int | None = None) -> dict[str, tuple]:
    """(shape, dtype) of each input of one batch; the agent dim leads
    when ``n_agents`` is given (the engines vmap over it): tokens and
    positions (B, S); an M-RoPE config's mrope_positions (3, B, S); a
    vision config's frontend_embeds (B, P, d) but at decode; an
    encoder-decoder config's enc_embeds (B, T, d), or at decode the
    encoder memory enc_out (B, T, d), T = ``enc_len`` (default S, 4096 at
    decode)."""
    lead = (n_agents,) if n_agents is not None else ()
    ids = torch.int64
    schema: dict[str, tuple] = {
        "tokens": (lead + (batch, seq), ids),
        "positions": (lead + (batch, seq), ids),
    }
    if cfg.rope_kind == "mrope":
        schema["mrope_positions"] = (lead + (3, batch, seq), ids)
    if cfg.frontend == "vision" and not decode:
        schema["frontend_embeds"] = (
            lead + (batch, cfg.frontend_positions, cfg.d_model),
            cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        el = enc_len if enc_len is not None else (4096 if decode else seq)
        # decode consumes the precomputed encoder memory, not raw frames
        schema["enc_out" if decode else "enc_embeds"] = (
            lead + (batch, el, cfg.d_model), cfg.compute_dtype)
    return schema


def _specs(schema: dict[str, tuple]) -> dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in schema.items()}


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      n_agents: int) -> dict:
    """A train or prefill shape's batch, split over ``n_agents`` (which
    must divide its global batch), as meta tensors."""
    assert shape.kind in ("train", "prefill")
    per_agent = shape.global_batch // n_agents
    assert per_agent * n_agents == shape.global_batch, \
        (shape.global_batch, n_agents)
    return _specs(batch_schema(cfg, n_agents, per_agent, shape.seq_len))


def decode_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """A decode shape's one-token batch, as meta tensors."""
    assert shape.is_decode
    return _specs(batch_schema(cfg, None, shape.global_batch, 1,
                               decode=True))


def concrete_batch(cfg: ArchConfig, n_agents: int | None, batch: int,
                   seq: int, draws, *, decode: bool = False,
                   enc_len: int | None = None) -> dict:
    """A real batch of the schema on ``draws.device``: tokens uniform in
    the vocabulary, positions 0 .. S-1 (every M-RoPE component too),
    embeddings N(0, 1)·0.02, drawn from ``draws`` in schema order."""
    schema = batch_schema(cfg, n_agents, batch, seq, decode=decode,
                          enc_len=enc_len)
    out = {}
    for name, (shape, dtype) in schema.items():
        if name == "tokens":
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=draws.generator,
                                      device=draws.device)
        elif name in ("positions", "mrope_positions"):
            out[name] = torch.arange(shape[-1], device=draws.device).expand(
                shape).contiguous()
        else:
            out[name] = (draws.normal(shape) * 0.02).to(dtype)
    return out
