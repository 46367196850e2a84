"""The gossip averaging step x_i ← Σ_j W_ij x_j (Algorithm 1, line 6).

Plain torch counterparts of repro/core/gossip.py for the flat (n, D)
buffer.  The ELL neighbour mix goes through kernels/ops.py, which runs
the plain version for CPU tensors and the CUDA kernel for CUDA ones;
graphs too skewed for the ELL layout keep the CSR gather here.
"""

from __future__ import annotations

import torch

from repro_torch.core import topology as topo
from repro_torch.kernels import ref

__all__ = ["ELL_MAX_DEG", "gossip_mix_dense", "make_sparse_gossip"]

ELL_MAX_DEG = 16  # below this, the padded neighbour loop beats CSR scatter

# y = W x as one (n, n) @ (n, D) matrix product with f32 accumulation: the
# plain version of kernel #1, which no kernel replaces on the dense path.
gossip_mix_dense = ref.gossip_mix


def make_sparse_gossip(graph: topo.Graph):
    """Neighbour-only mix over the graph's static edge structure.

    * isolated graph (FedAvg 𝒲 = {I}): y = W_ii x_i;
    * max degree ≤ ELL_MAX_DEG: the ELL mix (kernel #2 on CUDA);
    * skewed degrees: gather over the receiver-sorted CSR edge list and
      ``index_add_`` into the receivers, O(|E|·D).
    """
    max_deg = int(graph.degrees.max()) if graph.n else 0
    if max_deg == 0:
        return lambda w, x: torch.diagonal(w.to(x.dtype))[:, None] * x
    if max_deg <= ELL_MAX_DEG:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.make_sparse_gossip(graph)

    recv, send, _ = topo.csr_edges(graph)
    cache = {}

    def mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if x.device not in cache:
            cache[x.device] = (torch.as_tensor(recv, device=x.device).long(),
                               torch.as_tensor(send, device=x.device).long())
        r, s = cache[x.device]
        wd = w.to(x.dtype)
        own = torch.diagonal(wd)[:, None] * x
        return own.index_add(0, r, wd[r, s][:, None] * x[s])

    return mix
