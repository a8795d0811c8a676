"""Training steps (counterpart of ``ray_tpu/parallel``): single device so far."""
from ray_tpu_torch.parallel.train_step import (
    OptState,
    Optimizer,
    make_optimizer,
    make_train_state,
    make_train_step,
)

__all__ = ["OptState", "Optimizer", "make_optimizer", "make_train_state", "make_train_step"]
