"""The gumbel baseline's training losses (port of the DynamicViT part of
`dense2sparse_vit_tpu/losses/distill.py`): the keep-ratio loss, the
DynamicViT-paper distillation loss and the predictors' BCE against the
teacher's CLS-attention mask. Pure functions, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.losses.backbone_loss import cross_entropy, soft_target_cross_entropy
from dense2sparse_vit_torch.parallel import ratio_over_group
from dense2sparse_vit_torch.ops.topk import mask_from_scores


def keep_ratio_loss(pred_keep_probs: Sequence[torch.Tensor],
                    target_ratios: Sequence[float]) -> torch.Tensor:
    """Mean over the stages of the batch mean of (mean keep - target)^2.

    pred_keep_probs: per-stage (B, N_i) keep probabilities (or (B, N_i, 1)
    cumulative hard decisions)."""
    terms = [torch.mean((p.reshape(p.shape[0], -1).float().mean(dim=-1) - r) ** 2)
             for p, r in zip(pred_keep_probs, target_ratios)]
    return sum(terms, torch.zeros(())) / max(len(terms), 1)


def dynamic_vit_distill_loss(
    logits_s: torch.Tensor,
    tokens_s: torch.Tensor,
    logits_t: torch.Tensor,
    tokens_t: torch.Tensor,
    labels: torch.Tensor,
    pred_keep_probs: Sequence[torch.Tensor],
    decisions: torch.Tensor,
    target_ratios: Sequence[float],
    cls_weight: float = 1.0,
    ratio_weight: float = 2.0,
    dist_weight: float = 0.5,
    use_ratio_loss: bool = True,
    use_token_dist_loss: bool = True,
    mixup_active: bool = False,
    temperature: float = 1.0,
    group=None,
) -> Tuple[torch.Tensor, dict]:
    """The gumbel student's loss, the DynamicViT-paper recipe:

      cls_weight * CE + T^2 KL(teacher || student logits at temperature T)
      + ratio_weight * keep_ratio_loss + dist_weight * token MSE over the
      tokens still kept (`decisions`, (B, N, 1)).

    group: the data group of a DDP step, over which the token MSE's count
    of kept tokens is summed (`parallel.ratio_over_group`); every other
    term is a mean over the samples and needs nothing.

    Returns (loss, metrics) with the JAX function's metric names."""
    logits_s = logits_s.float()
    logits_t = logits_t.float()
    if mixup_active:
        cls = soft_target_cross_entropy(logits_s, labels)
    else:
        cls = cross_entropy(logits_s, labels)
    T = float(temperature)
    log_p = F.log_softmax(logits_s / T, dim=-1)
    log_q = F.log_softmax(logits_t / T, dim=-1)
    cls_kl = torch.sum(torch.exp(log_q) * (log_q - log_p)) / log_p.shape[0] * (T * T)

    loss = cls_weight * cls + cls_kl
    metrics = {"dyn_cls_loss": cls, "dyn_cls_kl": cls_kl}
    if use_ratio_loss:
        ratio = keep_ratio_loss(pred_keep_probs, target_ratios)
        loss = loss + ratio_weight * ratio
        metrics["dyn_ratio_loss"] = ratio
    if use_token_dist_loss:
        d = decisions.float()
        diff = (tokens_s.float() - tokens_t.float()) ** 2
        # the kept-token count couples the batch: summed over the data group,
        # a rank's term is world * sum_r / count_global, whose mean over the
        # ranks (DDP averages their gradients) is the global batch's MSE
        tok = ratio_over_group(torch.sum(diff.mean(dim=-1, keepdim=True) * d), torch.sum(d),
                               group)
        loss = loss + dist_weight * tok
        metrics["dyn_token_dist_loss"] = tok
    metrics["dyn_loss"] = loss
    return loss, metrics


def predictor_bce_vs_teacher(pred_keep_probs: Sequence[torch.Tensor],
                             teacher_target: torch.Tensor,
                             keep_ratios: Sequence[float]) -> torch.Tensor:
    """BCE of the predictors' keep probabilities against the teacher's mask:
    per stage, the top int(N * r) of the renormalised (B, N) teacher
    CLS attention (`aggregate_teacher_cls_attn`), the kept class weighted
    by (1 - r) / r; mean over the stages."""
    t = teacher_target.float()
    t = t / t.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    loss = torch.zeros((), dtype=torch.float32, device=t.device)
    for probs, r in zip(pred_keep_probs, keep_ratios):
        gt = mask_from_scores(t, r)
        p = probs.float().clamp(1e-7, 1.0 - 1e-7)
        w_pos = (1.0 - r) / r
        bce = -(w_pos * gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
        loss = loss + torch.mean(bce)
    return loss / max(len(pred_keep_probs), 1)


def kd_loss(logits_s: torch.Tensor, logits_t: torch.Tensor, labels: torch.Tensor,
            keep_decisions: torch.Tensor, epoch, temperature: float = 1.0,
            ratio_epochs: float = 40.0, min_ratio: float = 0.35) -> Tuple[torch.Tensor, dict]:
    """The mask-optimisation loss (`experiments.optimized_mask`): the fp32
    KL(teacher || student) at temperature T, summed and divided by B, times
    T^2, plus the CE of the student's logits, plus the keep-ratio penalty
    (max(min_ratio, 1 - epoch / ratio_epochs) - mean keep)^2.

    keep_decisions: (B, N) or (B, N, 1) keep decisions in [0, 1].
    Returns (loss, metrics) with the JAX function's metric names."""
    logits_s = logits_s.float()
    logits_t = logits_t.float()
    T = float(temperature)
    log_p = F.log_softmax(logits_s / T, dim=-1)
    log_q = F.log_softmax(logits_t / T, dim=-1)
    kl = torch.sum(torch.exp(log_q) * (log_q - log_p)) / log_p.shape[0] * (T * T)
    ce = cross_entropy(logits_s, labels)
    target_ratio = max(min_ratio, 1.0 - float(epoch) / ratio_epochs)
    mean_keep = keep_decisions.reshape(keep_decisions.shape[0], -1).float().mean()
    ratio_pen = (target_ratio - mean_keep) ** 2
    loss = kl + ce + ratio_pen
    return loss, {"kd_kl": kl, "kd_ce": ce, "kd_ratio_penalty": ratio_pen,
                  "kd_mean_keep": mean_keep}
