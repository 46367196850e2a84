"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38 blocks in a 2:1 RG-LRU : local-attention pattern, d_model 4096,
attn: 16 heads MQA (kv=1, head_dim 256) with window 2048, d_ff 12288,
vocab 256000.  f32 parameters, bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4_096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    sliding_window=2_048,       # all attention layers are local
    mlp_kind="geglu",
    tie_embeddings=True,
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
