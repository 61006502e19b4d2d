"""The training and eval steps (port of `dense2sparse_vit_tpu/train/
train_step.py::make_train_step`, `::make_dynamic_vit_train_step`,
`::make_eval_step` and `::make_dynamic_vit_eval_step`).

`make_train_step`, for `DiffPruningStudent` in every selection mode: the
frozen teacher's forward without gradients, or with `cached_teacher` its
outputs looked up from the teacher cache (`train/teacher_cache.py`); the
student in train mode (the JAX model's deterministic=False,
collect_cls_attns=False, which the attn selection overrides: it ranks by
the student's own CLS rows), given the teacher's CLS-attention stack with
cls_from_teacher and soft top-k at `sigma_schedule(epoch)` with
differentiable_topk, its forward recomputed in the backward with
`ModelConfig.remat` (not with the BatchNorm predictor, whose running
statistics would move twice: the JAX step ignores remat there too); mask
loss + (epoch >= warmup_epochs) * backbone loss (+ the early-exit head's
CE with early_exit), the class terms soft-target CEs under mixup;
backward; the AdamW update (an accumulation micro-step under
grad_accum_steps > 1). A BatchNorm predictor's running statistics move at
every (micro-)step, as the JAX step's mutable batch_stats do.
`make_dynamic_vit_train_step`, for the gumbel baseline: the teacher (or its
cached rows), the student's gumbel-policy forward, the DynamicViT
distillation loss (with the predictors' BCE against the teacher's mask if
asked), backward, AdamW; no warmup gate. `make_eval_step` and
`make_dynamic_vit_eval_step`: the teacher's, the pruned and the unpruned
forwards in eval mode, top-1 of each and the CE (with the mask loss for the
pruning student) over the rows whose label is not -1 (the padded tail of
the last batch). Every step takes uint8 images, which it normalises on
their device (`data.pipeline.device_normalize`), or normalised float ones.
The metric names are the JAX steps'.

Data parallelism: both train steps take the student wrapped by
`wrap_ddp` (DDP over the mesh's data group; the frozen teacher is not
wrapped). Each rank then computes on its shard of the global batch and DDP
averages the gradients; what couples the batch is made global: the
BatchNorm predictor's moments, the two kept-token denominators (the loss
functions' `group`) and the accumulated gradient, whose micro-steps other
than the last run under `no_sync` and whose running mean is averaged over
the group before the update (`ScheduledAdamW.process_group`). The metrics
a rank returns are its shard's (`parallel.global_batch_metrics` averages
them).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from dense2sparse_vit_torch.core.config import ExperimentConfig
from dense2sparse_vit_torch.data.pipeline import device_normalize
from dense2sparse_vit_torch.losses import (
    aggregate_teacher_cls_attn,
    backbone_loss,
    dynamic_vit_distill_loss,
    mask_loss,
    predictor_bce_vs_teacher,
)
from dense2sparse_vit_torch.losses.backbone_loss import cross_entropy, soft_target_cross_entropy
from dense2sparse_vit_torch.nn.predictor import set_batch_norm_group
from dense2sparse_vit_torch.train.optimizer import ScheduledAdamW
from dense2sparse_vit_torch.train.schedule import sigma_schedule


def prepare_images(images: torch.Tensor, cfg: ExperimentConfig) -> torch.Tensor:
    """uint8 images normalised on their device; float ones as they are."""
    if images.dtype == torch.uint8:
        return device_normalize(images, cfg.data)
    if not images.is_floating_point():
        raise TypeError(f"images must be uint8 or float (normalised), got {images.dtype}")
    return images


def teacher_outputs(teacher: nn.Module, teacher_in: Optional[dict], images: torch.Tensor,
                    cached_teacher: bool) -> dict:
    """The frozen teacher's supervision as a dict: 'logits', 'tokens',
    'token_probs', 'token_entropy', 'attns', 'target' (None where absent).
    Live: the teacher's forward on `images` (logits, tokens, attns). Cached:
    the rows `teacher_in` holds (`train/teacher_cache.py`): logits, target
    or attns, and token_probs with token_entropy or raw tokens."""
    if cached_teacher:
        if teacher_in is None:
            raise ValueError("cached_teacher: pass the batch's teacher rows as teacher_in")
        out = {k: teacher_in.get(k) for k in ("tokens", "token_probs", "token_entropy",
                                               "attns", "target")}
        return {"logits": teacher_in["logits"].float(), **out}
    teacher.eval()
    t_logits, t_tokens, t_attns = teacher(images)
    return {"logits": t_logits, "tokens": t_tokens, "token_probs": None,
            "token_entropy": None, "attns": t_attns, "target": None}


def remat_forward(run: Callable, generator: Optional[torch.Generator], *args):
    """`run(*args)` under activation checkpointing (the JAX step's
    jax.checkpoint around the student's forward): autograd keeps none of its
    activations and recomputes the forward in the backward. The recompute
    draws from `generator` as the forward did: torch's checkpoint restores
    the global RNG states, not a generator passed in, so the generator's
    state at the forward is set again for the recompute (and its state then
    put back), and DropPath scales, dropout masks and selection noise come
    out the same."""
    from torch.utils.checkpoint import checkpoint

    state = None if generator is None else generator.get_state()
    calls = [0]

    def fn(*a):
        calls[0] += 1
        if calls[0] == 1 or generator is None:
            return run(*a)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return run(*a)
        finally:
            generator.set_state(now)

    return checkpoint(fn, *args, use_reentrant=False)


# DDP's switch for not broadcasting the buffers at every forward: newer torch
# names it forward_sync_buffers and deprecates broadcast_buffers
NO_BUFFER_SYNC = ({"forward_sync_buffers": False}
                  if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                  else {"broadcast_buffers": False})


class StudentForward(nn.Module):
    """The student's train-mode forward as the module DDP wraps, with the
    `remat_forward` recompute inside it: a checkpoint around DDP's own
    forward would run DDP's forward again in the middle of the backward."""

    def __init__(self, student: nn.Module, remat: bool = False):
        super().__init__()
        self.student = student
        self.remat = remat

    def forward(self, images, generator=None, **kwargs):
        if self.remat:
            return remat_forward(lambda x: self.student(x, generator=generator, **kwargs),
                                 generator, images)
        return self.student(images, generator=generator, **kwargs)


def student_remat(cfg: ExperimentConfig) -> bool:
    """Whether a train step recomputes the student's forward: with
    ModelConfig.remat, except under the BatchNorm predictor (whose running
    statistics would move twice; the JAX step ignores remat there too)."""
    return cfg.model.remat and (cfg.pruning.selection == "gumbel" or not cfg.pruning.predictor_bn)


def wrap_ddp(student: nn.Module, cfg: ExperimentConfig, mesh) -> DistributedDataParallel:
    """The student under DDP over `mesh.data_group` (`core.mesh.make_mesh`),
    for `make_train_step` / `make_dynamic_vit_train_step`: its BatchNorm
    predictor layers take their statistics over that group, and the remat
    recompute runs inside the wrapped module (`StudentForward`). Buffers
    are not broadcast at each forward: the running statistics move alike on
    every rank."""
    set_batch_norm_group(student, mesh.data_group)
    # DDP raises when a parameter that requires grad gets none. Of the
    # modes, only teacher-CLS selection leaves some without: it ranks the
    # tokens by the teacher's CLS rows, and its predictors reach no loss.
    unused = cfg.pruning.cls_from_teacher and cfg.pruning.selection != "gumbel"
    return DistributedDataParallel(StudentForward(student, student_remat(cfg)),
                                   process_group=mesh.data_group,
                                   find_unused_parameters=unused, **NO_BUFFER_SYNC)


def _student_call(student: nn.Module, cfg: ExperimentConfig):
    """(the student a step trains, its forward(images, generator, **kw), the
    DDP wrapper or None) for a student or `wrap_ddp`'s wrapper of one."""
    if isinstance(student, DistributedDataParallel):
        if not isinstance(student.module, StudentForward):
            raise ValueError("a DDP student comes from wrap_ddp, whose module runs the "
                             "step's forward (and its remat recompute)")
        return student.module.student, student, student
    return student, StudentForward(student, student_remat(cfg)), None


def _sync_context(ddp, optimizer: ScheduledAdamW):
    """Where a step's forward and backward run. Under DDP, an accumulation
    micro-step other than the last runs without the gradient all-reduce
    (`no_sync`, which must hold the forward too): the optimizer averages its
    running mean over the group before the update instead."""
    if ddp is None:
        return contextlib.nullcontext()
    optimizer.process_group = ddp.process_group
    if optimizer.mini_step == optimizer.accum_steps - 1 or optimizer.accum_steps == 1:
        return contextlib.nullcontext()
    return ddp.no_sync()


def make_train_step(
    student: nn.Module,
    teacher: nn.Module,
    optimizer: ScheduledAdamW,
    cfg: ExperimentConfig,
    mixup_active: bool = False,
    generator: Optional[torch.Generator] = None,
    cached_teacher: bool = False,
) -> Callable:
    """Build `step(images, labels, epoch, teacher_in=None, generator=None)
    -> metrics`.

    student: the student, or `wrap_ddp`'s wrapper of it (module docstring);
    images: (B, H, W, 3) NHWC, uint8 or normalised float; labels: (B,)
    int, or with mixup_active (B, num_classes) soft targets; epoch: the
    current epoch, which gates the backbone loss (the lr schedules read the
    optimizer's update count); teacher_in: with cached_teacher, the batch's
    teacher rows, which replace the teacher's forward. metrics: {name: 0-d
    tensor}, detached, on the images' device. The student's random draws
    (DropPath's branch scales, a T2T performer stem's dropout) come from the
    call's `generator`, else the one given here, by default one seeded
    with TrainConfig.seed on the images' device at the first step. After the
    step every trained parameter's `.grad` holds this step's gradient (zero
    for one the loss does not reach, such as the unused predictors of a
    teacher-CLS student, which AdamW still decays, as optax does). In
    threshold mode the student's per-stage keep masks chain the mask loss's
    target and its last mask restricts the token KL. The metrics add
    `early_exit_loss` with early_exit.
    """
    tr, pr = cfg.train, cfg.pruning
    student, forward, ddp = _student_call(student, cfg)
    group = None if ddp is None else ddp.process_group
    draws = [generator]

    def step(images: torch.Tensor, labels: torch.Tensor, epoch,
             teacher_in: Optional[dict] = None,
             generator: Optional[torch.Generator] = None) -> dict:
        images = prepare_images(images, cfg)
        if generator is None:
            if draws[0] is None:
                draws[0] = torch.Generator(device=images.device).manual_seed(tr.seed)
            generator = draws[0]
        student.train()
        t = teacher_outputs(teacher, teacher_in, images, cached_teacher)
        with _sync_context(ddp, optimizer):
            loss, metrics = losses(images, labels, epoch, t, generator)
            student.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def losses(images, labels, epoch, t, generator):
        # no loss reads the student's own CLS rows (JAX `train_step.py:172`)
        kwargs = dict(collect_cls_attns=False)
        if pr.cls_from_teacher:
            kwargs["teacher_cls_attns"] = t["attns"]
        if pr.differentiable_topk:
            kwargs.update(soft_topk=True, sigma=sigma_schedule(epoch, tr.epochs, pr.initial_sigma))
        out = forward(images, generator=generator, **kwargs)
        m_loss, m_metrics = mask_loss(
            out.pred_logits, t["attns"], out.kept_idx, pr.keep_ratios,
            loss_type=pr.mask_loss_type, mean_heads=pr.mean_heads,
            keep_masks=out.keep_masks, teacher_target=t["target"],
        )
        b_loss, b_metrics = backbone_loss(
            out.logits, out.features, t["logits"], t["tokens"], labels,
            kept_idx_orig=out.kept_idx_orig, keep_mask=out.keep_mask,
            mixup_active=mixup_active, tokens_t_probs=t["token_probs"],
            tokens_t_entropy=t["token_entropy"], group=group,
        )
        # warmup gate: the mask loss alone for the first warmup epochs
        loss = m_loss + float(epoch >= tr.warmup_epochs) * b_loss
        if pr.early_exit and out.early_exit_logits is not None:
            ee_logits = out.early_exit_logits.float()
            ee = (soft_target_cross_entropy(ee_logits, labels) if mixup_active
                  else cross_entropy(ee_logits, labels))
            loss = loss + ee
            m_metrics = {**m_metrics, "early_exit_loss": ee}
        return loss, {**m_metrics, **b_metrics, "loss": loss}

    return step


def make_dynamic_vit_train_step(
    student: nn.Module,
    teacher: nn.Module,
    optimizer: ScheduledAdamW,
    cfg: ExperimentConfig,
    mixup_active: bool = False,
    generator: Optional[torch.Generator] = None,
    cached_teacher: bool = False,
) -> Callable:
    """Build `step(images, labels, epoch, teacher_in=None, generator=None)
    -> metrics` for the gumbel baseline (`DynamicViTStudent`, or `wrap_ddp`'s
    wrapper of it), as `make_train_step` does for the pruning student (the
    cached rows hold
    the teacher's raw tokens for this loss).

    The loss is `dynamic_vit_distill_loss` with the TrainConfig's
    cls_weight, ratio_weight, dist_weight, use_ratio_loss,
    use_token_dist_loss and softmax_temp, plus, with teacher_cls_loss, the
    predictors' BCE against the teacher's aggregated CLS attention (the
    cache's target where cached). `epoch` is taken for the same signature
    and unused: the recipe has no warmup gate. The gumbel noise comes from
    the call's `generator`, else the one given here, by default one seeded with
    TrainConfig.seed on the images' device at the first step. With
    `ModelConfig.remat` the student's forward is recomputed in the backward
    (`remat_forward`) with the same draws; the JAX step has no remat, and
    the gradients are the same either way.
    """
    tr, pr = cfg.train, cfg.pruning
    student, forward, ddp = _student_call(student, cfg)
    group = None if ddp is None else ddp.process_group
    noise = [generator]

    def step(images: torch.Tensor, labels: torch.Tensor, epoch,
             teacher_in: Optional[dict] = None,
             generator: Optional[torch.Generator] = None) -> dict:
        del epoch
        images = prepare_images(images, cfg)
        if generator is None:
            if noise[0] is None:
                noise[0] = torch.Generator(device=images.device).manual_seed(tr.seed)
            generator = noise[0]
        student.train()
        t = teacher_outputs(teacher, teacher_in, images, cached_teacher)
        with _sync_context(ddp, optimizer):
            loss, metrics = losses(images, labels, t, generator)
            student.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    def losses(images, labels, t, generator):
        out = forward(images, generator=generator)
        loss, metrics = dynamic_vit_distill_loss(
            out.logits, out.features, t["logits"], t["tokens"], labels, out.pred_keep_probs,
            out.decisions, pr.keep_ratios, cls_weight=tr.cls_weight,
            ratio_weight=tr.ratio_weight, dist_weight=tr.dist_weight,
            use_ratio_loss=tr.use_ratio_loss, use_token_dist_loss=tr.use_token_dist_loss,
            mixup_active=mixup_active, temperature=tr.softmax_temp, group=group,
        )
        if tr.teacher_cls_loss:
            target = t["target"]
            if target is None:
                target = aggregate_teacher_cls_attn(t["attns"], pr.mean_heads)
            bce = predictor_bce_vs_teacher(out.pred_keep_probs, target.float(), pr.keep_ratios)
            loss = loss + bce
            metrics = {**metrics, "dyn_teacher_cls_bce": bce}
        return loss, {**metrics, "loss": loss}

    return step


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


def make_eval_step(student: nn.Module, teacher: nn.Module, cfg: ExperimentConfig) -> Callable:
    """Build `eval_step(images, labels) -> metrics` for `DiffPruningStudent`.

    The teacher's forward (its CLS rows: the bf16 CLS-row kernel with
    fused blocks), the student's pruned and unpruned eval forwards (the
    student's own blocks: int8 with quant="int8"), the mask loss against
    the teacher's CLS rows plus the CE: `val_<mask metrics>`, `val_loss`,
    `val_cls_loss`, `val_acc`, `unpruned_acc`, `teacher_acc`, `n_valid`,
    and in threshold mode `min/avg/max_keep_ratio`. Rows with label -1 are
    padding and count in no metric. Runs without gradients. Both student
    forwards get the teacher's CLS-attention stack with cls_from_teacher;
    random selection draws from a generator seeded with 0 at each call, and
    a BatchNorm predictor normalises with its running statistics (JAX
    `train_step.py:397-420`).
    """
    pr = cfg.pruning

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        images = prepare_images(images, cfg)
        teacher.eval()
        student.eval()
        n_valid, accuracy, cross_entropy = _masked_scores(labels)
        t_logits, _, t_attns = teacher(images)
        # no eval metric reads the student's own CLS rows (JAX `train_step.py:415`)
        kwargs = dict(collect_cls_attns=False)
        if pr.cls_from_teacher:
            kwargs["teacher_cls_attns"] = t_attns
        out = student(images, **kwargs)
        out_unpruned = student(images, unpruned=True, **kwargs)
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

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        images = prepare_images(images, cfg)
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
