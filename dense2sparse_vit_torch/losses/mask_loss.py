"""Mask-predictor supervision losses (port of
`dense2sparse_vit_tpu/losses/mask_loss.py`).

The predictors' per-token scores are supervised by the frozen teacher's CLS
attention: averaged over layers, max (or mean) over heads, renormalised
over the spatial tokens, and at each later pruning stage gathered by the
previous stage's kept indices and renormalised. Pure functions returning
(loss, metrics), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops.topk import mask_from_scores


def aggregate_teacher_cls_attn(cls_attns: torch.Tensor, mean_heads: bool = False) -> torch.Tensor:
    """(B, L, H, N+1) teacher CLS-attention stack -> (B, N) fp32 target."""
    t = cls_attns.float().mean(dim=1)  # (B, H, N+1)
    t = t.mean(dim=1) if mean_heads else t.amax(dim=1)
    t = t[:, 1:]
    return t / t.sum(dim=-1, keepdim=True)


def _kl_batchmean_log_target(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """sum(exp(log_q) * (log_q - log_p)) / batch, torch's kl_div with
    log_target=True and reduction='batchmean'."""
    return torch.sum(torch.exp(log_q) * (log_q - log_p)) / log_p.shape[0]


def mask_loss(
    pred_logits: Sequence[torch.Tensor],
    teacher_cls_attns: Optional[torch.Tensor],
    kept_idx: Sequence[torch.Tensor],
    keep_ratios: Sequence[float],
    loss_type: str = "kl_div",
    mean_heads: bool = False,
    keep_masks: Sequence[torch.Tensor] = (),
    teacher_target: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Mask-prediction loss over all pruning stages.

    pred_logits: per-stage raw predictor scores, stage i (B, N_i);
    teacher_cls_attns: (B, L, H, N+1), unused when `teacher_target` (a
      precomputed (B, N) aggregate) is given;
    kept_idx: per-stage kept indices in stage-local coordinates, which chain
      the target from one stage to the next; with none, `keep_masks` (the
      threshold mode's per-stage (B, N) masks) restrict it instead;
    keep_ratios: the per-stage keep ratios of the config;
    loss_type: 'kl_div' | 'mse' | 'bce'.
    Returns (loss, metrics) with the per-stage mask accuracies `mask_acc_i`
    and `mask_loss`.
    """
    if teacher_target is not None:
        renorm = teacher_target.float()
        renorm = renorm / renorm.sum(dim=-1, keepdim=True)
    else:
        renorm = aggregate_teacher_cls_attn(teacher_cls_attns, mean_heads)
    loss = torch.zeros((), dtype=torch.float32, device=renorm.device)
    metrics = {}
    for i, logits in enumerate(pred_logits):
        logits = logits.float()
        if i > 0:
            if kept_idx:
                renorm = torch.gather(renorm, 1, kept_idx[i - 1])
            else:
                renorm = renorm * keep_masks[i - 1].to(renorm.dtype)
            # a zero keep mask gives a zero target (KL 0), not 0/0
            renorm = renorm / renorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
            stage_ratio = keep_ratios[i] / keep_ratios[i - 1]
        else:
            stage_ratio = keep_ratios[i]

        if loss_type == "kl_div":
            # exact-zero targets add 0; floor the log so 0 * log 0 is not NaN
            safe_log = torch.log(renorm.clamp_min(1e-30))
            loss = loss + _kl_batchmean_log_target(F.log_softmax(logits, dim=-1), safe_log)
        elif loss_type == "mse":
            # raw scores against the renormalised attention, scaled by 100
            loss = loss + 100.0 * torch.mean((logits - renorm) ** 2)
        elif loss_type == "bce":
            # BCE with logits against the teacher's top-k mask, the kept
            # class weighted by (1 - r) / r against the imbalance
            gt = mask_from_scores(renorm, stage_ratio)
            pos_w = (1.0 - stage_ratio) / stage_ratio
            bce = -(pos_w * gt * F.logsigmoid(logits) + (1.0 - gt) * F.logsigmoid(-logits))
            loss = loss + torch.mean(bce)
        else:
            raise ValueError(f"unknown mask loss type {loss_type!r}")

        # predicted top-k mask against the teacher's: ranking the raw logits
        # gives the same mask as ranking their softmax or sigmoid
        pred_mask = mask_from_scores(logits.detach(), stage_ratio)
        gt_mask = mask_from_scores(renorm, stage_ratio)
        metrics[f"mask_acc_{i}"] = (pred_mask == gt_mask).float().mean()

    metrics["mask_loss"] = loss
    return loss, metrics
