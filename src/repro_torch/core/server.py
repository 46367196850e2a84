"""Server aggregation with partial participation (Algorithm 1, lines 7–10).

Every H-th step the server samples K agents uniformly with replacement,
averages them with weights c/K (c the count of each agent), and
broadcasts the average back to every agent (repro/core/server.py).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["sample_participants", "participant_weights",
           "aggregate_and_broadcast", "server_round",
           "aggregate_and_broadcast_flat", "server_round_flat",
           "server_round_sweep"]


def sample_participants(draws, t: int, n: int, k: int) -> torch.Tensor:
    """Draw S_t: K indices uniform over [n] with replacement → counts (n,).

    The counts are an integer scatter-add, not ``torch.bincount``, whose
    CUDA form reads the largest index back to the host: the round would
    wait there for the device (the population engine dispatches the next
    cohort's upload behind it)."""
    idx = draws.participants(t, n, k)
    counts = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def participant_weights(counts: torch.Tensor, k: int) -> torch.Tensor:
    """Aggregation weights c/K in f32 (sum to 1)."""
    return counts.to(torch.float32) / float(k)


def aggregate_and_broadcast(weights: torch.Tensor, stacked):
    """z = Σ_i weights_i x_i for every leaf of a stacked tree (a tensor or
    a dict of them, every leaf (n, ...)), written into every agent's slot.

    In place, leaf by leaf, as :func:`aggregate_and_broadcast_flat`: the
    caller hands over a tree it owns (the tree engine passes the freshly
    mixed x^{t+1}), so every leaf stays real contiguous storage that the
    next step's kernels and in-place updates can take (a broadcast view
    would be stride 0 along the agents).
    """
    def agg(leaf: torch.Tensor) -> torch.Tensor:
        leaf = leaf.contiguous()
        rows = leaf.view(leaf.shape[0], -1)
        rows.copy_(torch.matmul(weights.to(leaf.dtype), rows).unsqueeze(0)
                   .expand_as(rows))
        return leaf
    return tree_map(agg, stacked)


def server_round(draws, t: int, stacked, k: int):
    """Sample S_t and aggregate+broadcast a stacked tree (lines 8–10 of
    Alg. 1, repro/core/server.py:60-65), in place."""
    n = leaves(stacked)[0].shape[0]
    counts = sample_participants(draws, t, n, k)
    return aggregate_and_broadcast(participant_weights(counts, k), stacked)


def aggregate_and_broadcast_flat(weights: torch.Tensor,
                                 flat: torch.Tensor) -> torch.Tensor:
    """z = Σ_i weights_i x_i, written into every row of ``flat``.

    In place: the caller hands over a buffer it owns (the engine passes
    the freshly mixed x^{t+1}), so the broadcast costs no second (n, D)
    allocation.  The weights are cast to the buffer's dtype first, as the
    reference casts them before its contraction.  The contraction runs in
    column blocks of ``_SERVER_COLS``, since cuBLAS takes dimensions and
    leading dimensions below 2^31 (a Mistral-Large-123B row at three
    layers is 5.0e9): a narrower buffer is one block, the buffer itself,
    and one call.
    """
    w = weights.to(flat.dtype)
    for lo in range(0, flat.shape[1], _SERVER_COLS):
        block = flat[:, lo:lo + _SERVER_COLS]
        z = torch.matmul(w, block.contiguous())
        block.copy_(z.unsqueeze(0).expand_as(block))
    return flat


_SERVER_COLS = 1 << 30


def server_round_flat(draws, t: int, flat: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Flat-buffer server round (lines 8–10) on the (n, D) buffer."""
    counts = sample_participants(draws, t, flat.shape[0], k)
    return aggregate_and_broadcast_flat(participant_weights(counts, k), flat)


def server_round_sweep(draws, t, flat: torch.Tensor, k: int,
                       fire) -> torch.Tensor:
    """The lattice's server round on the (R, n, D) buffer, in place.

    Every run draws its K participants at every step (``draws`` gives an
    (R, K) block), so the position in the random stream never depends on
    H; the counts' z_r = Σ_i (c_i/K) x_i is written into the rows of the
    runs in ``fire`` (those whose (t+1) % h_r == 0) and the other runs'
    rows are left alone (repro/core/sweep.py:432-443).
    """
    r_runs, n = flat.shape[:2]
    idx = draws.participants(t, n, k).to(flat.device)
    counts = torch.zeros((r_runs, n), dtype=torch.int32, device=flat.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    weights = participant_weights(counts, k)
    for r in np.flatnonzero(fire):
        aggregate_and_broadcast_flat(weights[r], flat[r])
    return flat
