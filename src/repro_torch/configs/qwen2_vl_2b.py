"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

28 layers, d_model 1536, 12 heads (GQA kv 2, head_dim 128), d_ff 8960,
vocab 151936, QKV bias.  M-RoPE (temporal/height/width rotary sections);
the ViT vision tower is a stub: a batch's ``frontend_embeds`` are
pre-projected patch embeddings that take the first
``frontend_positions`` slots (launch/specs.py).  Full attention;
``long_variant`` decodes with the 4,096-token window.  f32 parameters,
bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,              # Qwen2 family uses QKV bias
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    long_context_window=4_096,  # the window of long_variant decode
    mlp_kind="swiglu",
    frontend="vision",
    frontend_positions=256,     # stubbed patch embeddings
    compute_dtype=torch.bfloat16,
)
