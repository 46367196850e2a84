"""Architecture + run configuration (counterpart of repro/configs/base.py).

The fields the port's models read: the dense GQA language model (with
Qwen1.5's QKV bias and long-context window), Griffin's RG-LRU /
local-attention hybrid, the Mamba2 SSD stack, DeepSeek's MoE and MLA
blocks, Qwen2-VL's M-RoPE with its vision-stub prefix and SeamlessM4T's
encoder-decoder, with the reference's analytic parameter counts.  Dtypes
are torch dtypes in place of ``jnp`` ones.  Of the sharding fields the
tensor-parallel ones are ported (``tp_axis_name``,
``attn_weight_gather``); ``batch_axis_name`` names a serving constraint
that the port has no counterpart of.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "ArchConfig",
           "FedConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts (DeepSeek-style: shared + routed, token-choice)."""

    num_experts: int               # routed experts
    num_shared: int                # always-on shared experts
    top_k: int
    d_ff_expert: int               # per-expert hidden dim
    capacity_factor: float = 1.25  # C = ceil(S·k/E · cf)
    router_aux_weight: float = 1e-3
    first_dense_layers: int = 1    # leading dense layers (dsv3: 3, v2-lite: 1)
    d_ff_dense: int = 0            # hidden dim of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek V2/V3)."""

    kv_lora_rank: int              # latent dim for K/V (cached at decode)
    q_lora_rank: int = 0           # 0 ⇒ full-rank Q projection (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    """A stack of attention (GQA or MLA), SSM or RG-LRU blocks, each
    attention or RG-LRU block with a dense MLP or an MoE; an
    encoder-decoder config adds an encoder stack and cross-attention, a
    frontend config takes stub embeddings (vision patches or audio
    frames) in place of its frontend."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    arch_type: str = "dense"       # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""               # citation of the published config
    head_dim: int = 0              # 0 ⇒ d_model // num_heads (gqa)

    # attention
    attention_kind: str = "gqa"    # gqa | mla | none
    qkv_bias: bool = False
    rope_kind: str = "rope"        # rope | mrope | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0 ⇒ local layers use this window
    global_every: int = 0          # every n-th layer global (0 ⇒ none)
    long_context_window: int = 0   # >0 ⇒ the window of long_variant decode

    # block pattern for hybrids: tuple like ("rglru", "rglru", "attn")
    block_pattern: tuple[str, ...] = ()

    mlp_kind: str = "swiglu"       # swiglu | geglu | relu2 | gelu

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None

    # encoder-decoder (seamless)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0

    # modality frontend stub: None | "vision" | "audio"
    frontend: str | None = None
    frontend_positions: int = 0    # positions consumed by frontend embeds

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    # federated deployment (repro/configs/base.py:111-112): 'sharded'
    # trains one agent per slice of the mesh's data axes, 'replicated'
    # fed_n_agents_replicated agents per pod (sharding.n_agents_for)
    fed_agent_layout: str = "sharded"
    fed_n_agents_replicated: int = 4

    # set at lowering time by launch/steps.adapt_for_mesh
    # (repro/configs/base.py:114-125): ``tp_axis_name`` names the mesh dim
    # whose ambient model group (sharding/tp.py) partitions the model's
    # compute, and ``attn_weight_gather`` marks a head count that does not
    # divide it: the attention then gathers its weights on use and splits
    # the sequence over the group (models/attention.py)
    attn_weight_gather: bool = False
    tp_axis_name: str | None = None

    def __post_init__(self):
        if self.head_dim == 0 and self.attention_kind == "gqa":
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.attention_kind == "gqa" and \
                self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads must divide by kv "
                             f"heads")
        if self.arch_type == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe config required")
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

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v  # head
        for li in range(self.num_layers):
            total += self._block_params(li)
        if self.is_encoder_decoder:
            for li in range(self.encoder_layers):
                total += self._block_params(li)
            total += self.num_layers * self._cross_attn_params()
        return total

    def num_active_params(self) -> int:
        """Active-per-token count (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * \
            m.d_ff_expert
        moe_layers = self.num_layers - m.first_dense_layers
        return self.num_params() - moe_layers * inactive

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention_kind == "mla":
            c = self.mla
            qk = c.qk_nope_head_dim + c.qk_rope_head_dim
            q_in = (d * c.q_lora_rank + c.q_lora_rank * self.num_heads * qk
                    if c.q_lora_rank else d * self.num_heads * qk)
            kv_in = d * (c.kv_lora_rank + c.qk_rope_head_dim)
            kv_up = c.kv_lora_rank * self.num_heads * (
                c.qk_nope_head_dim + c.v_head_dim)
            out = self.num_heads * c.v_head_dim * d
            return q_in + kv_in + kv_up + out
        hd = self.head_dim
        return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)

    def _cross_attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _block_params(self, layer_idx: int) -> int:
        """The reference's count of one block (its norms' and biases'
        terms as it writes them)."""
        kind = self.block_kind(layer_idx)
        d = self.d_model
        if kind == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            return (d * (2 * di + 2 * s.d_state + nh)  # in_proj(z,x,B,C,dt)
                    + s.d_conv * (di + 2 * s.d_state)  # conv
                    + 2 * nh                            # A_log, D
                    + di * d)                           # out_proj
        total = self._mlp_params(self._layer_d_ff(layer_idx)) + 2 * d
        if kind == "attn":
            total += self._attn_params()
        elif kind == "rglru":
            # linear recurrent unit block: in/out projections + gates + conv
            total += 2 * d * self.d_ff_rglru + 2 * self.d_ff_rglru
        if self.moe is not None and layer_idx >= self.moe.first_dense_layers:
            m = self.moe
            total += d * m.num_experts  # router
            total += m.num_shared * self._mlp_params(m.d_ff_expert)
            total += m.num_experts * self._mlp_params(m.d_ff_expert)
            total -= self._mlp_params(self._layer_d_ff(layer_idx))
        return total

    @property
    def d_ff_rglru(self) -> int:
        return self.d_model  # lru width = d_model (recurrentgemma)

    def _layer_d_ff(self, layer_idx: int) -> int:
        """The MLP width of a layer: an MoE config's leading dense layers
        take ``d_ff_dense`` (``d_ff`` where it is 0)."""
        if self.moe is not None and layer_idx < self.moe.first_dense_layers:
            return self.moe.d_ff_dense or self.d_ff
        return self.d_ff

    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant (the reference's ``smoke``): ≤ the
        block pattern's length of layers (2 at least), d_model ≤ 256,
        ≤ 4 heads of 64, vocab ≤ 512, window ≤ 32, a long-context window
        of 64 where there is one, ≤ 2 encoder layers, ≤ 8 frontend
        positions, ≤ 4 experts (top 2) of width ≤ 128,
        an MLA of rank 64 and head dims 32/16/32, f32."""
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
            encoder_layers=min(self.encoder_layers, 2),
            frontend_positions=min(self.frontend_positions, 8),
            sliding_window=(min(self.sliding_window, 32)
                            if self.sliding_window else 0),
            global_every=min(self.global_every, 2) if self.global_every
            else 0,
            long_context_window=64 if self.long_context_window else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
        if self.moe is not None:
            updates["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                num_shared=min(self.moe.num_shared, 1), top_k=2, d_ff_expert=min(self.moe.d_ff_expert, 128),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=min(self.moe.d_ff_dense, 256)
                if self.moe.d_ff_dense else 0)
        if self.mla is not None:
            updates["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64,
                q_lora_rank=32 if self.mla.q_lora_rank else 0,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
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
