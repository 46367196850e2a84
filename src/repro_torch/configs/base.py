"""Architecture + run configuration (counterpart of repro/configs/base.py).

Only the fields the dense GQA language model of the port reads; dtypes are
torch dtypes in place of ``jnp`` ones.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ArchConfig", "FedConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A dense decoder-only transformer (GQA attention, SwiGLU MLP)."""

    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 ⇒ d_model // num_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads must divide by kv "
                             f"heads")


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
