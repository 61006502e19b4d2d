"""Learning-rate schedules, soft top-k's noise schedule and the keep-ratio
and threshold curricula (port of `dense2sparse_vit_tpu/train/schedule.py`).

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


def sigma_schedule(epoch, epochs: int, initial_sigma: float = 0.05):
    """Perturbed top-k's noise std: linear from initial_sigma at epoch 0 to
    0 at `epochs`, then 0."""
    sigma = (1.0 - epoch / epochs) * initial_sigma
    return torch.clamp(sigma, min=0.0) if isinstance(sigma, torch.Tensor) else max(sigma, 0.0)


def current_keep_ratio(epoch, min_ratio: float = 0.3, ramp_epochs: int = 90):
    """Keep-ratio curriculum: linear from 1.0 at epoch 0 down to min_ratio
    at ramp_epochs, then min_ratio."""
    ratio = 1.0 - (1.0 - min_ratio) / ramp_epochs * epoch
    return torch.clamp(ratio, min=min_ratio) if isinstance(ratio, torch.Tensor) else max(ratio, min_ratio)


def current_patch_score_threshold(epoch, base: float = 0.1, maximum: float = 0.5,
                                  ramp_epochs: int = 90):
    """Threshold curriculum: linear from base at epoch 0 up to maximum at
    ramp_epochs, then maximum."""
    th = (maximum - base) / ramp_epochs * epoch + base
    return torch.clamp(th, max=maximum) if isinstance(th, torch.Tensor) else min(th, maximum)
