"""Learning-rate schedules (port of `dense2sparse_vit_tpu/train/schedule.py`).

Pure functions of the epoch, which may be a Python number or a tensor; the
schedules step once per epoch.
"""

from __future__ import annotations

import math

import torch

from dense2sparse_vit_torch.core.config import TrainConfig


def cosine_lr(epoch, cfg: TrainConfig):
    """Cosine from cfg.lr at epoch 0 to cfg.min_lr at cfg.epochs."""
    arg = epoch / cfg.epochs * math.pi
    cos = (torch.cos(arg) if isinstance(arg, torch.Tensor) else math.cos(arg)) + 1.0
    return cfg.min_lr + cos * 0.5 * (cfg.lr - cfg.min_lr)


def predictor_lr(epoch, cfg: TrainConfig):
    """The predictors always train at the cosine lr."""
    return cosine_lr(epoch, cfg)


def backbone_lr(epoch, cfg: TrainConfig, warmup_freeze: bool = True):
    """The backbone: 0 under freeze_backbone and, with `warmup_freeze`, while
    epoch < cfg.warmup_epochs; else min(lr * backbone_lr_scale, cosine lr).

    warmup_freeze=False keeps the cap and drops the warmup's zero: the
    DynamicViT gumbel baseline fine-tunes the whole model from epoch 0."""
    cos = cosine_lr(epoch, cfg)
    tensor = isinstance(cos, torch.Tensor)
    if cfg.freeze_backbone:
        return torch.zeros_like(cos) if tensor else 0.0
    cap = cfg.lr * cfg.backbone_lr_scale
    lr = torch.clamp(cos, max=cap) if tensor else min(cap, cos)
    if not warmup_freeze:
        return lr
    if tensor:
        return torch.where(epoch < cfg.warmup_epochs, torch.zeros_like(lr), lr)
    return 0.0 if epoch < cfg.warmup_epochs else lr
