"""Parameter groups and AdamW with per-group schedules (port of
`dense2sparse_vit_tpu/train/optimizer.py`).

Groups, by parameter name (the rules of the JAX package's `label_params`
for the modules the port has; it has no early-exit head or distillation
token):
  frozen        cls_token, pos_embed and the T2T performer's projection
                (`tokens_to_token.attention{1,2}.w`, JAX `prm_w`): in no
                group, never updated (optax's set_to_zero)
  predictor     the score predictors: the cosine lr, weight decay
  base_no_decay 1-D parameters and biases: the backbone's lr, no decay
  base_decay    everything else: the backbone's lr, weight decay
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from dense2sparse_vit_torch.core.config import TrainConfig
from dense2sparse_vit_torch.train import schedule as sched

GROUPS = ("predictor", "base_decay", "base_no_decay")


def _is_performer_projection(name: str) -> bool:
    """The frozen random projection of a T2T performer unit: `w` directly
    under tokens_to_token.attention{1,2} (the reference's key for JAX's
    `prm_w`, `optimizer.py:38-42`)."""
    parts = name.split(".")
    return parts[-1] == "w" and "tokens_to_token" in parts


def label_params(model: nn.Module) -> Dict[str, str]:
    """{parameter name: group label}, "frozen" included."""

    def label(name: str, p: torch.Tensor) -> str:
        n = name.lower()
        if "cls_token" in n or "pos_embed" in n or _is_performer_projection(n):
            return "frozen"
        if "score_predictor" in n:
            return "predictor"
        if p.dim() <= 1 or n.endswith("bias"):
            return "base_no_decay"
        return "base_decay"

    return {name: label(name, p) for name, p in model.named_parameters()}


class ScheduledAdamW(torch.optim.AdamW):
    """torch.optim.AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight
    decay, as optax.adamw) with one parameter group per label. Before every
    update each group's lr is set from its schedule at the epoch
    `count // steps_per_epoch`, where `count` is the number of updates made
    so far: optax evaluates a schedule at the update count before it
    increments. Set `count` to start the schedule later (a resumed run).
    backbone_warmup_freeze=False trains the backbone during the warmup
    epochs too (`schedule.backbone_lr`'s warmup_freeze), as the gumbel
    baseline's recipe does."""

    def __init__(self, groups, cfg: TrainConfig, steps_per_epoch: int,
                 backbone_warmup_freeze: bool = True):
        super().__init__(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=cfg.weight_decay)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.backbone_warmup_freeze = backbone_warmup_freeze
        self.count = 0

    def group_lr(self, label: str, epoch) -> float:
        if label == "predictor":
            return sched.predictor_lr(epoch, self.cfg)
        return sched.backbone_lr(epoch, self.cfg, warmup_freeze=self.backbone_warmup_freeze)

    def step(self, closure=None):
        epoch = self.count // self.steps_per_epoch
        for group in self.param_groups:
            group["lr"] = float(self.group_lr(group["label"], epoch))
        loss = super().step(closure)
        self.count += 1
        return loss


def make_optimizer(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                   backbone_warmup_freeze: bool = True) -> ScheduledAdamW:
    """AdamW over `model`'s parameters in the groups of `label_params`.
    backbone_warmup_freeze=False: the backbone trains from epoch 0 (the gumbel
    baseline; JAX `make_optimizer`'s switch of the same name)."""
    labels = label_params(model)
    params = dict(model.named_parameters())
    wd = {"predictor": cfg.weight_decay, "base_decay": cfg.weight_decay,
          "base_no_decay": 0.0}
    groups = []
    for g in GROUPS:
        members = [params[n] for n, lbl in labels.items() if lbl == g]
        if members:
            groups.append({"params": members, "label": g, "weight_decay": wd[g]})
    return ScheduledAdamW(groups, cfg, steps_per_epoch, backbone_warmup_freeze)
