"""Synthetic heterogeneous federated LM data (repro/data/federated_lm.py).

Each agent i draws tokens from its own unigram distribution (a Dirichlet
split of the vocabulary; small α ⇒ strongly non-iid agents), with a
bigram kick: the successor of the previous token gets a logit boost, so
sequences carry learnable next-token structure.  All draws come from a
:class:`repro_torch.core.draws.Draws` object on the data's device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["FederatedLMData", "make_federated_lm"]


@dataclasses.dataclass(frozen=True)
class FederatedLMData:
    """Per-agent token-stream sampler."""

    vocab_size: int
    n_agents: int
    seq_len: int
    agent_logits: torch.Tensor   # (n_agents, vocab) unigram logits, f32
    shift_strength: float        # P(t+1 | t) ∝ exp(logits + 4s·[t+1])

    def sample(self, draws, per_agent_batch: int) -> torch.Tensor:
        """(n_agents, per_agent_batch, seq_len) int64 tokens."""
        return self._sample(draws, self.agent_logits, per_agent_batch)

    def sample_agents(self, draws, agents: torch.Tensor,
                      per_agent_batch: int) -> torch.Tensor:
        """(len(agents), per_agent_batch, seq_len) int64 tokens of the
        agents ``agents`` (an int64 index tensor on the data's device):
        a population cohort's batch."""
        return self._sample(draws, self.agent_logits[agents],
                            per_agent_batch)

    def _sample(self, draws, logits: torch.Tensor,
                per_agent_batch: int) -> torch.Tensor:
        n, v = logits.shape
        base = logits[:, None, :].expand(n, per_agent_batch, v)
        tok = draws.categorical(base)                      # (n, B)
        out = [tok]
        kick = torch.full((n, per_agent_batch, 1), 4.0 * self.shift_strength,
                          dtype=base.dtype, device=base.device)
        for _ in range(self.seq_len - 1):
            nxt = ((tok + 1) % v)[..., None]
            tok = draws.categorical(base.scatter_add(-1, nxt, kick))
            out.append(tok)
        return torch.stack(out, dim=-1)


def make_federated_lm(vocab_size: int, n_agents: int, seq_len: int, draws,
                      alpha: float = 0.3,
                      shift_strength: float = 1.0) -> FederatedLMData:
    """Build the per-agent distributions on ``draws.device``.

    Args:
      alpha: Dirichlet concentration; smaller ⇒ more heterogeneous agents.
    """
    probs = draws.dirichlet(alpha, n_agents, vocab_size)
    return FederatedLMData(vocab_size=vocab_size, n_agents=n_agents,
                           seq_len=seq_len,
                           agent_logits=torch.log(probs + 1e-9),
                           shift_strength=shift_strength)
