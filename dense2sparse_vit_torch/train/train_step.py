"""The training steps (port of `dense2sparse_vit_tpu/train/train_step.py::
make_train_step` and `::make_dynamic_vit_train_step`).

`make_train_step`, for `DiffPruningStudent` in top-k or threshold mode: the
frozen teacher's forward without gradients; the student in train mode (the
JAX model's deterministic=False, collect_cls_attns=False); mask loss +
(epoch >= warmup_epochs) * backbone loss; backward; the AdamW update.
`make_dynamic_vit_train_step`, for the gumbel baseline: the teacher, the
student's gumbel-policy forward, the DynamicViT distillation loss (with the
predictors' BCE against the teacher's mask if asked), backward, AdamW; no
warmup gate. The metric names are the JAX steps'. The eval steps and the
threshold curriculum are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn

from dense2sparse_vit_torch.core.config import ExperimentConfig, reject_unported
from dense2sparse_vit_torch.losses import (
    aggregate_teacher_cls_attn,
    backbone_loss,
    dynamic_vit_distill_loss,
    mask_loss,
    predictor_bce_vs_teacher,
)
from dense2sparse_vit_torch.train.optimizer import ScheduledAdamW


def _reject_unported(cfg: ExperimentConfig, mixup_active: bool) -> None:
    reject_unported({
        "mixup": mixup_active,
        "teacher_cache": cfg.train.teacher_cache,
        "grad_accum_steps > 1": cfg.train.grad_accum_steps > 1,
    })


def make_train_step(
    student: nn.Module,
    teacher: nn.Module,
    optimizer: ScheduledAdamW,
    cfg: ExperimentConfig,
    mixup_active: bool = False,
) -> Callable:
    """Build `step(images, labels, epoch) -> metrics`.

    images: (B, H, W, 3) float NHWC; labels: (B,) int64; epoch: the current
    epoch, which gates the backbone loss (the lr schedules read the
    optimizer's update count). metrics: {name: 0-d tensor}, detached. After
    the step every trained parameter's `.grad` holds this step's gradient.
    In threshold mode the student's per-stage keep masks chain the mask
    loss's target and its last mask restricts the token KL. Mixup, the
    frozen-teacher cache and gradient accumulation are not ported yet and
    are rejected, as the student rejects early exit, soft top-k,
    teacher-CLS selection and the BatchNorm predictor.
    """
    tr, pr = cfg.train, cfg.pruning
    _reject_unported(cfg, mixup_active)

    def step(images: torch.Tensor, labels: torch.Tensor, epoch) -> dict:
        if not images.is_floating_point():
            raise TypeError(f"images must be float (normalised), got {images.dtype}")
        teacher.eval()
        student.train()
        t_logits, t_tokens, t_attns = teacher(images)
        out = student(images)
        m_loss, m_metrics = mask_loss(
            out.pred_logits, t_attns, out.kept_idx, pr.keep_ratios,
            loss_type=pr.mask_loss_type, mean_heads=pr.mean_heads,
            keep_masks=out.keep_masks,
        )
        b_loss, b_metrics = backbone_loss(
            out.logits, out.features, t_logits, t_tokens, labels,
            kept_idx_orig=out.kept_idx_orig, keep_mask=out.keep_mask,
        )
        # warmup gate: the mask loss alone for the first warmup epochs
        loss = m_loss + float(epoch >= tr.warmup_epochs) * b_loss
        student.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        metrics = {**m_metrics, **b_metrics, "loss": loss}
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_dynamic_vit_train_step(
    student: nn.Module,
    teacher: nn.Module,
    optimizer: ScheduledAdamW,
    cfg: ExperimentConfig,
    mixup_active: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """Build `step(images, labels, epoch) -> metrics` for the gumbel
    baseline (`DynamicViTStudent`), as `make_train_step` does for the
    pruning student.

    The loss is `dynamic_vit_distill_loss` with the TrainConfig's
    cls_weight, ratio_weight, dist_weight, use_ratio_loss,
    use_token_dist_loss and softmax_temp, plus, with teacher_cls_loss, the
    predictors' BCE against the teacher's aggregated CLS attention. `epoch`
    is taken for the same signature and unused: the recipe has no warmup
    gate. The gumbel noise comes from `generator`, by default one seeded
    with TrainConfig.seed on the images' device at the first step.
    """
    tr, pr = cfg.train, cfg.pruning
    _reject_unported(cfg, mixup_active)
    noise = [generator]

    def step(images: torch.Tensor, labels: torch.Tensor, epoch) -> dict:
        del epoch
        if not images.is_floating_point():
            raise TypeError(f"images must be float (normalised), got {images.dtype}")
        if noise[0] is None:
            noise[0] = torch.Generator(device=images.device).manual_seed(tr.seed)
        teacher.eval()
        student.train()
        t_logits, t_tokens, t_attns = teacher(images)
        out = student(images, generator=noise[0])
        loss, metrics = dynamic_vit_distill_loss(
            out.logits, out.features, t_logits, t_tokens, labels, out.pred_keep_probs,
            out.decisions, pr.keep_ratios, cls_weight=tr.cls_weight,
            ratio_weight=tr.ratio_weight, dist_weight=tr.dist_weight,
            use_ratio_loss=tr.use_ratio_loss, use_token_dist_loss=tr.use_token_dist_loss,
            temperature=tr.softmax_temp,
        )
        if tr.teacher_cls_loss:
            target = aggregate_teacher_cls_attn(t_attns, pr.mean_heads)
            bce = predictor_bce_vs_teacher(out.pred_keep_probs, target, pr.keep_ratios)
            loss = loss + bce
            metrics = {**metrics, "dyn_teacher_cls_bce": bce}
        student.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        metrics = {**metrics, "loss": loss}
        return {k: v.detach() for k, v in metrics.items()}

    return step
