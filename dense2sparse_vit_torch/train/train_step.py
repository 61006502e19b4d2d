"""The training and eval steps (port of `dense2sparse_vit_tpu/train/
train_step.py::make_train_step`, `::make_dynamic_vit_train_step`,
`::make_eval_step` and `::make_dynamic_vit_eval_step`).

`make_train_step`, for `DiffPruningStudent` in top-k or threshold mode: the
frozen teacher's forward without gradients; the student in train mode (the
JAX model's deterministic=False, collect_cls_attns=False, which the attn
selection overrides: it ranks by the student's own CLS rows); mask loss +
(epoch >= warmup_epochs) * backbone loss; backward; the AdamW update.
`make_dynamic_vit_train_step`, for the gumbel baseline: the teacher, the
student's gumbel-policy forward, the DynamicViT distillation loss (with the
predictors' BCE against the teacher's mask if asked), backward, AdamW; no
warmup gate. `make_eval_step` and `make_dynamic_vit_eval_step`: the
teacher's, the pruned and the unpruned forwards in eval mode, top-1 of each
and the CE (with the mask loss for the pruning student) over the rows whose
label is not -1 (the padded tail of the last batch). The metric names are
the JAX steps'. The threshold curriculum is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """Build `step(images, labels, epoch) -> metrics`.

    images: (B, H, W, 3) float NHWC; labels: (B,) int64; epoch: the current
    epoch, which gates the backbone loss (the lr schedules read the
    optimizer's update count). metrics: {name: 0-d tensor}, detached. The
    student's random draws (DropPath's branch scales, a T2T performer
    stem's dropout) come from `generator`, by default one seeded with
    TrainConfig.seed on the images' device at the first step. After
    the step every trained parameter's `.grad` holds this step's gradient.
    In threshold mode the student's per-stage keep masks chain the mask
    loss's target and its last mask restricts the token KL. Mixup, the
    frozen-teacher cache and gradient accumulation are not ported yet and
    are rejected, as the student rejects early exit, soft top-k,
    teacher-CLS selection and the BatchNorm predictor.
    """
    tr, pr = cfg.train, cfg.pruning
    _reject_unported(cfg, mixup_active)
    draws = [generator]

    def step(images: torch.Tensor, labels: torch.Tensor, epoch) -> dict:
        if not images.is_floating_point():
            raise TypeError(f"images must be float (normalised), got {images.dtype}")
        if draws[0] is None:
            draws[0] = torch.Generator(device=images.device).manual_seed(tr.seed)
        teacher.eval()
        student.train()
        t_logits, t_tokens, t_attns = teacher(images)
        # no loss reads the student's own CLS rows (JAX `train_step.py:172`)
        out = student(images, collect_cls_attns=False, generator=draws[0])
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


def _reject_unported_eval(cfg: ExperimentConfig) -> None:
    pr = cfg.pruning
    reject_unported({
        "selection == 'random'": pr.selection == "random",
        "cls_from_teacher": pr.cls_from_teacher,
        "predictor_bn": pr.predictor_bn,
    })


def _masked_scores(labels: torch.Tensor):
    """(n_valid, top-1 accuracy of logits, CE of logits), each over the rows
    whose label is >= 0; n_valid is at least 1."""
    valid = (labels >= 0).float()
    n_valid = valid.sum().clamp_min(1.0)
    labels = labels.clamp_min(0)

    def accuracy(logits):
        return ((logits.argmax(-1) == labels).float() * valid).sum() / n_valid

    def cross_entropy(logits):
        logp = F.log_softmax(logits.float(), dim=-1)
        return (-logp.gather(1, labels[:, None])[:, 0] * valid).sum() / n_valid

    return n_valid, accuracy, cross_entropy


def _check_images(images: torch.Tensor) -> None:
    if not images.is_floating_point():
        raise TypeError(f"images must be float (normalised), got {images.dtype}")


def make_eval_step(student: nn.Module, teacher: nn.Module, cfg: ExperimentConfig) -> Callable:
    """Build `eval_step(images, labels) -> metrics` for `DiffPruningStudent`.

    The teacher's forward (its CLS rows: the bf16 CLS-row kernel with
    fused blocks), the student's pruned and unpruned eval forwards (the
    student's own blocks: int8 with quant="int8"), the mask loss against
    the teacher's CLS rows plus the CE: `val_<mask metrics>`, `val_loss`,
    `val_cls_loss`, `val_acc`, `unpruned_acc`, `teacher_acc`, `n_valid`,
    and in threshold mode `min/avg/max_keep_ratio`. Rows with label -1 are
    padding and count in no metric. Runs without gradients. The options the
    port does not have (random and teacher-CLS selection, the BatchNorm
    predictor) are rejected.
    """
    pr = cfg.pruning
    _reject_unported_eval(cfg)

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        _check_images(images)
        teacher.eval()
        student.eval()
        n_valid, accuracy, cross_entropy = _masked_scores(labels)
        t_logits, _, t_attns = teacher(images)
        # no eval metric reads the student's own CLS rows (JAX `train_step.py:415`)
        out = student(images, collect_cls_attns=False)
        out_unpruned = student(images, unpruned=True, collect_cls_attns=False)
        m_loss, m_metrics = mask_loss(
            out.pred_logits, t_attns, out.kept_idx, pr.keep_ratios,
            loss_type=pr.mask_loss_type, mean_heads=pr.mean_heads, keep_masks=out.keep_masks,
        )
        ce = cross_entropy(out.logits)
        metrics = {
            **{f"val_{k}": v for k, v in m_metrics.items()},
            "val_loss": m_loss + ce,
            "val_cls_loss": ce,
            "val_acc": accuracy(out.logits),
            "unpruned_acc": accuracy(out_unpruned.logits),
            "teacher_acc": accuracy(t_logits),
            "n_valid": n_valid,
        }
        if out.keep_ratios is not None:
            ratios = out.keep_ratios.float()
            metrics.update(min_keep_ratio=ratios.min(), avg_keep_ratio=ratios.mean(),
                           max_keep_ratio=ratios.max())
        return metrics

    return eval_step


def make_dynamic_vit_eval_step(student: nn.Module, teacher: nn.Module,
                               cfg: ExperimentConfig) -> Callable:
    """Build `eval_step(images, labels) -> metrics` for the gumbel baseline
    (`DynamicViTStudent`): its pruned eval forward (top-k gathers), its
    unpruned one and the teacher's; `val_loss` = `val_cls_loss` (the CE),
    `val_acc`, `unpruned_acc`, `teacher_acc`, `n_valid`, with the same
    label == -1 padding as `make_eval_step`."""
    del cfg  # the same signature as make_eval_step; the baseline has no options here

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        _check_images(images)
        teacher.eval()
        student.eval()
        n_valid, accuracy, cross_entropy = _masked_scores(labels)
        t_logits, _, _ = teacher(images)
        out = student(images)
        out_unpruned = student(images, unpruned=True)
        ce = cross_entropy(out.logits)
        return {
            "val_loss": ce,
            "val_cls_loss": ce,
            "val_acc": accuracy(out.logits),
            "unpruned_acc": accuracy(out_unpruned.logits),
            "teacher_acc": accuracy(t_logits),
            "n_valid": n_valid,
        }

    return eval_step
