"""Local optimizers and learning-rate schedules of the port."""

from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, momentum_sgd,
                                          sgd)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "momentum_sgd",
           "schedules", "sgd"]
