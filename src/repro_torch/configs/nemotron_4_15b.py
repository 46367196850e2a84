"""Nemotron-4-15B [arXiv:2402.16819].

32L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), d_ff 24576 with
squared-ReLU (non-gated) MLP, vocab 256000.  Full attention;
``long_variant`` decodes with the 4,096-token window.  f32 parameters,
bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    source="arXiv:2402.16819",
    num_layers=32,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_kind="relu2",
    long_context_window=4_096,
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
