"""Schedules, parameter groups with AdamW, and the train and eval steps."""

from dense2sparse_vit_torch.train.optimizer import (
    GROUPS,
    ScheduledAdamW,
    label_params,
    make_optimizer,
)
from dense2sparse_vit_torch.train.schedule import backbone_lr, cosine_lr, predictor_lr
from dense2sparse_vit_torch.train.train_step import (
    make_dynamic_vit_eval_step,
    make_dynamic_vit_train_step,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "GROUPS", "ScheduledAdamW", "backbone_lr", "cosine_lr", "label_params",
    "make_dynamic_vit_eval_step", "make_dynamic_vit_train_step", "make_eval_step",
    "make_optimizer", "make_train_step", "predictor_lr",
]
