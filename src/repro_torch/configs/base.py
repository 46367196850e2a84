"""Architecture + run configuration (counterpart of repro/configs/base.py).

The fields the port's models read: the dense GQA language model (with
Qwen1.5's QKV bias and long-context window), Griffin's RG-LRU /
local-attention hybrid and the Mamba2 SSD stack.  Dtypes are
torch dtypes in place of ``jnp`` ones.  MoE, MLA, encoder-decoder and
frontend fields are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["SSMConfig", "ArchConfig", "FedConfig"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block dimensions."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A decoder-only stack of attention, SSM or RG-LRU blocks."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    arch_type: str = "dense"       # dense | ssm | hybrid
    source: str = ""               # citation of the published config
    head_dim: int = 0              # 0 ⇒ d_model // num_heads (gqa)

    # attention
    attention_kind: str = "gqa"    # gqa | none
    qkv_bias: bool = False
    rope_kind: str = "rope"        # rope | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0 ⇒ local layers use this window
    global_every: int = 0          # every n-th layer global (0 ⇒ none)
    long_context_window: int = 0   # >0 ⇒ the window of long_variant decode

    # block pattern for hybrids: tuple like ("rglru", "rglru", "attn")
    block_pattern: tuple[str, ...] = ()

    mlp_kind: str = "swiglu"       # swiglu | geglu
    ssm: SSMConfig | None = None

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.head_dim == 0 and self.attention_kind == "gqa":
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.attention_kind == "gqa" and \
                self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads must divide by kv "
                             f"heads")
        if self.arch_type == "ssm" and self.ssm is None:
            raise ValueError(f"{self.name}: ssm config required")

    def is_local_layer(self, layer_idx: int) -> bool:
        """Every ``global_every``-th layer is global, the others local."""
        if self.sliding_window <= 0:
            return False
        if self.global_every <= 0:
            return True
        return (layer_idx + 1) % self.global_every != 0

    def block_kind(self, layer_idx: int) -> str:
        if self.block_pattern:
            return self.block_pattern[layer_idx % len(self.block_pattern)]
        if self.arch_type == "ssm":
            return "ssm"
        return "attn"

    @property
    def d_ff_rglru(self) -> int:
        return self.d_model  # lru width = d_model (recurrentgemma)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant (the reference's ``smoke``): ≤ the
        block pattern's length of layers (2 at least), d_model ≤ 256,
        ≤ 4 heads of 64, vocab ≤ 512, window ≤ 32, a long-context window
        of 64 where there is one, f32."""
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        updates: dict[str, Any] = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers,
                           max(2, len(self.block_pattern) or 2)),
            d_model=min(self.d_model, 256),
            num_heads=(heads // kv) * kv or kv,
            num_kv_heads=kv,
            head_dim=64 if self.attention_kind == "gqa" else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 32)
                            if self.sliding_window else 0),
            global_every=min(self.global_every, 2) if self.global_every
            else 0,
            long_context_window=64 if self.long_context_window else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.ssm is not None:
            updates["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=16)
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated-run knobs layered on top of an ArchConfig."""

    n_agents: int = 16
    h: int = 10
    k: int = 4
    graph: str = "ring2"           # ring<k> | geo<r> | er<p> | full
    p_fail: float = 0.0
    gossip_impl: str = "dense"     # dense | pallas | sparse | none
    # gossip payload compression with error feedback (core/compress.py):
    # none | identity | bf16 | int8 | topk:R
    gossip_compress: str = "none"
    # delta parameterization of the agent state (core/delta.py):
    # none | full | topk:K | lowrank:R, mutually exclusive with
    # gossip_compress; 'full' is lossless
    delta: str = "none"
