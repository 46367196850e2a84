"""Mamba2-2.7B [arXiv:2405.21060].

64 attention-free SSD layers, d_model 2560 (d_inner 5120, 80 heads of 64,
state 128, conv 4), vocab 50280.  f32 parameters, bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2_560,
    num_heads=1,                 # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    attention_kind="none",
    rope_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
