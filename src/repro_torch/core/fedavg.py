"""FedAvg (McMahan et al.), the paper's baseline (repro/core/fedavg.py).

FedAvg is FedDec with the degenerate mixing distribution 𝒲 = {I}: agents
run H local steps, then the server samples K of them with replacement,
averages and broadcasts.  Reusing the FedDec step with the W = I fast
path (``gossip_impl='none'``, which skips the mix) makes the two
algorithms differ only in gossip, the experimental control of the
paper's Fig. 4.
"""

from __future__ import annotations

from repro_torch.core.mixing import identity_mixing

__all__ = ["FedAvgConfig", "make_fedavg_step", "make_fedavg_round",
           "make_fedavg_flat_round"]


def FedAvgConfig(n_agents: int, h: int = 10, k: int = 2):
    """FedDecConfig specialised to FedAvg (identity mixing, no gossip)."""
    from repro_torch.core.feddec import FedDecConfig
    return FedDecConfig(mixing=identity_mixing(n_agents), h=h, k=k,
                        server_enabled=True, gossip_impl="none")


def make_fedavg_step(n_agents: int, grad_fn, lr_fn, h: int = 10, k: int = 2,
                     *, device):
    """The tree engine's FedAvg step, make_feddec_step's signature."""
    from repro_torch.core import feddec
    return feddec.make_feddec_step(FedAvgConfig(n_agents, h=h, k=k),
                                   grad_fn, lr_fn, device=device)


def make_fedavg_round(n_agents: int, grad_fn, lr_fn, h: int = 10, k: int = 2,
                      metrics_fn=None, *, device):
    """The tree engine's FedAvg round: make_feddec_round with 𝒲 = {I};
    batches lead with the round's steps, metrics stack to (H,), the
    server fires on every H-th step."""
    from repro_torch.core import feddec
    return feddec.make_feddec_round(FedAvgConfig(n_agents, h=h, k=k),
                                    grad_fn, lr_fn, metrics_fn=metrics_fn,
                                    device=device)


def make_fedavg_flat_round(n_agents: int, spec, grad_fn, lr_fn, h: int = 10,
                           k: int = 2, metrics_fn=None, *, device):
    """The flat engine's FedAvg round on the (n, D) buffer: the local
    updates and the server's average, no mix."""
    from repro_torch.core import flat as flat_lib
    return flat_lib.make_flat_feddec_round(
        FedAvgConfig(n_agents, h=h, k=k), spec, grad_fn, lr_fn,
        device=device, metrics_fn=metrics_fn)
