"""DeepSeek-V3 671B [arXiv:2412.19437].

61L, d_model 7168, 128 heads with MLA (kv_lora 512, q_lora 1536,
qk 128 nope + 64 rope, v 128); MoE with 1 shared + 256 routed experts,
top-8, expert d_ff 2048 (first 3 layers dense, d_ff 18432); vocab 129280.
bf16 parameters (the momentum slot in f32), bf16 compute.  The
reference's docstring names an MTP (multi-token prediction) head in
``repro.models.mtp``; the reference has no such module, and the port
has none.  The reference's ``replicated`` agent layout (one agent FSDP-
sharded over the whole mesh) is not ported: the port has no mesh.
"""

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7_168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18_432,                 # dense-layer FFN width
    vocab_size=129_280,
    attention_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1_536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, num_shared=1, top_k=8,
                  d_ff_expert=2_048, capacity_factor=1.25,
                  first_dense_layers=3, d_ff_dense=18_432),
    long_context_window=4_096,
    mlp_kind="swiglu",
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    fed_agent_layout="replicated",
    fed_n_agents_replicated=1,
)
