"""Training: losses, the train step and the Trainer."""

from distributed_pytorch_tpu_torch.training.losses import (
    mse_loss,
    softmax_cross_entropy_loss,
)
from distributed_pytorch_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_train_step,
)
from distributed_pytorch_tpu_torch.training.trainer import Trainer

__all__ = [
    "TrainState",
    "Trainer",
    "create_train_state",
    "make_train_step",
    "mse_loss",
    "softmax_cross_entropy_loss",
]
