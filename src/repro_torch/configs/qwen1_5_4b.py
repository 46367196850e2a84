"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family, scaled per assignment].

40 layers, d_model 2560, 20 heads MHA (kv 20, head_dim 128), d_ff 6912,
vocab 151936, QKV bias.  Full attention; ``long_variant`` decodes with
the 4,096-token window.  f32 parameters, bf16 compute.  The serving
CLI's default model (launch/serve.py).
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=40,
    d_model=2_560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6_912,
    vocab_size=151_936,
    qkv_bias=True,
    long_context_window=4_096,
    mlp_kind="swiglu",
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
