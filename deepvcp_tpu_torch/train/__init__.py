"""Training of the port (counterpart of deepvcp_tpu/train): the train and
eval steps, Trainer and the CLI (`python -m deepvcp_tpu_torch.train`).
TrainConfig is the port's copy (deepvcp_tpu_torch/config.py), re-exported."""

from deepvcp_tpu_torch.config import TrainConfig
from deepvcp_tpu_torch.train.metrics import MetricsLogger, load_metrics
from deepvcp_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    build_train_step,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "TrainConfig",
    "Trainer",
    "TrainState",
    "build_train_step",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "MetricsLogger",
    "load_metrics",
]
