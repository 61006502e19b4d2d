"""Training losses, pure functions returning (loss, metrics)."""

from dense2sparse_vit_torch.losses.backbone_loss import (
    backbone_loss,
    cross_entropy,
    soft_target_cross_entropy,
)
from dense2sparse_vit_torch.losses.mask_loss import aggregate_teacher_cls_attn, mask_loss

__all__ = [
    "aggregate_teacher_cls_attn", "backbone_loss", "cross_entropy", "mask_loss",
    "soft_target_cross_entropy",
]
