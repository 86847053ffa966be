"""Training of the port: losses, optimizer, LR schedule, the train and eval
steps."""

from .engine import (StepDraws, TrainConfig, TrainStep, make_eval_step,
                     make_per_example_correct_step, make_train_step, normalize)
from .losses import (cross_entropy, label_smoothing_cross_entropy,
                     soft_target_cross_entropy, top_k_correct)
from .optim import (OptimConfig, lr_schedule, make_optimizer, timm_epoch_lrs,
                    weight_decay_groups)
from .state import TrainState

__all__ = [
    "OptimConfig",
    "StepDraws",
    "TrainConfig",
    "TrainState",
    "TrainStep",
    "cross_entropy",
    "label_smoothing_cross_entropy",
    "lr_schedule",
    "make_eval_step",
    "make_optimizer",
    "make_per_example_correct_step",
    "make_train_step",
    "normalize",
    "soft_target_cross_entropy",
    "timm_epoch_lrs",
    "top_k_correct",
    "weight_decay_groups",
]
