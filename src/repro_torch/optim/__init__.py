"""Optimizers of the round: client SGD (+momentum), server Adam."""
from repro_torch.optim.optimizers import (adam_init, adam_update, global_norm,
                                          sgd_init, sgd_update)

__all__ = ["adam_init", "adam_update", "global_norm", "sgd_init",
           "sgd_update"]
