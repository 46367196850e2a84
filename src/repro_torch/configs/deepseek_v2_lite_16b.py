"""DeepSeek-V2-Lite 16B [arXiv:2405.04434].

27L, d_model 2048, 16 heads with MLA (kv_lora 512, full-rank Q,
qk 128 nope + 64 rope, v 128); MoE 2 shared + 64 routed top-6, expert
d_ff 1408 (first layer dense, d_ff 10944); vocab 102400.  f32
parameters, bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10_944,
    vocab_size=102_400,
    attention_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                  d_ff_expert=1_408, capacity_factor=1.25,
                  first_dense_layers=1, d_ff_dense=10_944),
    long_context_window=4_096,
    mlp_kind="swiglu",
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
