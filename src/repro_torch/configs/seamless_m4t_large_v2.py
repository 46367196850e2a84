"""SeamlessM4T-Large-v2 transformer backbone [arXiv:2308.11596].

Encoder-decoder: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(kv 16, head_dim 64), d_ff 8192, vocab 256206, GELU MLPs.  The speech
frontend (mel-spectrogram + conformer feature extractor) is a stub: a
batch's ``enc_embeds`` are precomputed frame embeddings, the encoder's
input (launch/specs.py).  The decoder's self-attention takes the
4,096-token window under ``long_variant``; its cross-attention attends
the encoder memory (4,096 frames in a decode batch's schema).  f32
parameters, bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    source="arXiv:2308.11596",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8_192,
    vocab_size=256_206,
    is_encoder_decoder=True,
    encoder_layers=24,
    long_context_window=4_096,
    mlp_kind="gelu",
    frontend="audio",
    compute_dtype=torch.bfloat16,
)
