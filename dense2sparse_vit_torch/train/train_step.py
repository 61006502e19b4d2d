"""The training step (port of `dense2sparse_vit_tpu/train/train_step.py::
make_train_step`).

One step: the frozen teacher's forward without gradients; the student in
train mode (the JAX model's deterministic=False, collect_cls_attns=False);
mask loss + (epoch >= warmup_epochs) * backbone loss; backward; the AdamW
update. The metric names are the JAX step's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from dense2sparse_vit_torch.core.config import ExperimentConfig
from dense2sparse_vit_torch.losses import backbone_loss, mask_loss
from dense2sparse_vit_torch.train.optimizer import ScheduledAdamW


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
    Mixup, the frozen-teacher cache and gradient accumulation are not ported
    yet and are rejected, as the student rejects early exit, soft top-k,
    teacher-CLS selection and the BatchNorm predictor.
    """
    tr, pr = cfg.train, cfg.pruning
    unported = {
        "mixup": mixup_active,
        "teacher_cache": tr.teacher_cache,
        "grad_accum_steps > 1": tr.grad_accum_steps > 1,
    }
    missing = [name for name, used in unported.items() if used]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")

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
