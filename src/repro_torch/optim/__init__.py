"""Local optimizers of the port."""

from repro_torch.optim.optimizers import Optimizer, momentum_sgd, sgd

__all__ = ["Optimizer", "momentum_sgd", "sgd"]
