"""Training losses, pure functions returning (loss, metrics)."""

from dense2sparse_vit_torch.losses.backbone_loss import (
    backbone_loss,
    cross_entropy,
    soft_target_cross_entropy,
)
from dense2sparse_vit_torch.losses.distill import (
    dynamic_vit_distill_loss,
    kd_loss,
    keep_ratio_loss,
    predictor_bce_vs_teacher,
)
from dense2sparse_vit_torch.losses.mask_loss import aggregate_teacher_cls_attn, mask_loss

__all__ = [
    "aggregate_teacher_cls_attn", "backbone_loss", "cross_entropy",
    "dynamic_vit_distill_loss", "kd_loss", "keep_ratio_loss", "mask_loss",
    "predictor_bce_vs_teacher", "soft_target_cross_entropy",
]
