"""Schedules, parameter groups with AdamW, and the train and eval steps (the
epoch loop is `train.loop`, the teacher cache `train.teacher_cache`)."""

from dense2sparse_vit_torch.train.optimizer import (
    GROUPS,
    ScheduledAdamW,
    label_params,
    make_optimizer,
)
from dense2sparse_vit_torch.train.schedule import (
    backbone_lr,
    cosine_lr,
    current_keep_ratio,
    current_patch_score_threshold,
    predictor_lr,
    sigma_schedule,
)
from dense2sparse_vit_torch.train.train_step import (
    make_dynamic_vit_eval_step,
    make_dynamic_vit_train_step,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "GROUPS", "ScheduledAdamW", "backbone_lr", "cosine_lr", "current_keep_ratio",
    "current_patch_score_threshold", "label_params",
    "make_dynamic_vit_eval_step", "make_dynamic_vit_train_step", "make_eval_step",
    "make_optimizer", "make_train_step", "predictor_lr", "sigma_schedule",
]
