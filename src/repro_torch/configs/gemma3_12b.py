"""Gemma3-12B [hf:google/gemma-3-1b-pt family, scaled per assignment].

48L, d_model 3840, 16 heads (GQA kv=8, head_dim 256), d_ff 15360,
vocab 262144.  5:1 local:global attention interleave: five 1024-window
sliding layers per full-attention layer.  f32 parameters, bf16 compute.
"""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    rope_theta=1_000_000.0,
    sliding_window=1_024,       # local layers
    global_every=6,             # every 6th layer is global (5:1)
    mlp_kind="geglu",
    tie_embeddings=True,
    compute_dtype=torch.bfloat16,
    fed_agent_layout="sharded",
)
