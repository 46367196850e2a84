"""Static configuration of a FedDec run (repro/core/feddec.py).

FedAvg is the same configuration with the degenerate mixing 𝒲 = {I} and
the W = I fast path (``gossip_impl='none'``), see :func:`FedAvgConfig`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine
from repro_torch.core.mixing import MixingDistribution, identity_mixing

__all__ = ["FedDecConfig", "FedAvgConfig"]


@dataclasses.dataclass(frozen=True)
class FedDecConfig:
    """Static configuration of the federated run.

    Attributes:
      mixing: the distribution 𝒲 of mixing matrices (graph + link failures).
      h: server-round period H (ℋ = {t : t ≡ 0 mod H}).
      k: number of devices sampled per server round (with replacement).
      server_enabled: disable to get pure decentralized gossip SGD.
      gossip_impl: how Σ_j W_ij x_j is executed on the flat buffer:
        'dense'  — one (n, n) @ (n, D) matrix product;
        'none'   — W = I (FedAvg: skip the mix);
        'pallas' — the streaming gossip kernel (#1, kernels/csrc);
        'sparse' — neighbour-only mix over the graph's edges (the ELL
                   kernel #2 on CUDA, CSR gather for skewed graphs).
      gossip_compress: the gossip payload's codec with error feedback
        (core/compress.py): none | identity | bf16 | int8 | topk:R.
        Ignored under gossip_impl 'none' (nothing is exchanged).
    """

    mixing: MixingDistribution
    h: int = 10
    k: int = 2
    server_enabled: bool = True
    gossip_impl: str = "dense"
    gossip_compress: str = "none"

    GOSSIP_IMPLS = engine.GOSSIP_IMPLS

    def __post_init__(self):
        if self.h < 1:
            raise ValueError(f"H must be >= 1, got {self.h}")
        if self.k < 1:
            raise ValueError(f"K must be >= 1, got {self.k}")
        compress_lib.parse_compress(self.gossip_compress)  # validate spec
        engine.check_gossip_impl(self.gossip_impl)

    @property
    def n_agents(self) -> int:
        return self.mixing.n


def FedAvgConfig(n_agents: int, h: int = 10, k: int = 2) -> FedDecConfig:
    """FedDecConfig specialised to FedAvg (identity mixing, no gossip)."""
    return FedDecConfig(mixing=identity_mixing(n_agents), h=h, k=k,
                        server_enabled=True, gossip_impl="none")
