"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model 12288, 96 heads (GQA kv=8, head_dim 128), d_ff 28672,
vocab 32768.  Plain dense GQA decoder.  Full attention; ``long_variant``
decodes with the 4,096-token window.  bf16 parameters (the flat buffer
and every agent row in bf16, the momentum slot in f32), bf16 compute.
The reference's ``replicated`` agent layout (4 FSDP-sharded cross-silo
agents) is not ported: the port has no mesh.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
    long_context_window=4_096,
    mlp_kind="swiglu",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    fed_agent_layout="replicated",
    fed_n_agents_replicated=4,
)
