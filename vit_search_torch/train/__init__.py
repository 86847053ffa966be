"""Training of the port: losses, optimizer, LR schedule, the train and eval
steps, the EMA and checkpoints."""

from .checkpoint import (CheckpointManager, load_finetune, restore_raw,
                         unpack_checkpoint_archive)
from .engine import (StepDraws, TrainConfig, TrainStep, make_eval_step,
                     make_per_example_correct_step, make_teacher, make_train_step, normalize)
from .losses import (cross_entropy, distillation_loss, label_smoothing_cross_entropy,
                     soft_target_cross_entropy, top_k_correct)
from .optim import (OptimConfig, clip_by_global_norm_, global_norm, lr_schedule,
                    make_optimizer, timm_epoch_lrs, weight_decay_groups)
from .state import TrainState, ema_update, init_ema

__all__ = [
    "CheckpointManager",
    "OptimConfig",
    "StepDraws",
    "TrainConfig",
    "TrainState",
    "TrainStep",
    "clip_by_global_norm_",
    "cross_entropy",
    "distillation_loss",
    "ema_update",
    "global_norm",
    "init_ema",
    "label_smoothing_cross_entropy",
    "load_finetune",
    "lr_schedule",
    "make_eval_step",
    "make_optimizer",
    "make_per_example_correct_step",
    "make_teacher",
    "make_train_step",
    "normalize",
    "restore_raw",
    "soft_target_cross_entropy",
    "timm_epoch_lrs",
    "top_k_correct",
    "unpack_checkpoint_archive",
    "weight_decay_groups",
]
