"""Local optimizers and learning-rate schedules of the port."""

from repro_torch.optim import schedules
from repro_torch.optim.optimizers import Optimizer, momentum_sgd, sgd

__all__ = ["Optimizer", "momentum_sgd", "schedules", "sgd"]
