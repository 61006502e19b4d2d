"""Parameter groups and AdamW with per-group schedules (port of
`dense2sparse_vit_tpu/train/optimizer.py`).

Groups, by parameter name (the rules of the JAX package's `label_params`
for the modules the port has; it has no distillation token):
  frozen        cls_token, pos_embed and the T2T performer's projection
                (`tokens_to_token.attention{1,2}.w`, JAX `prm_w`): in no
                group, never updated (optax's set_to_zero)
  early_exit    the early-exit head, its LayerNorm bias included: the
                predictors' schedule and weight decay
  predictor     the score predictors: the cosine lr, weight decay
  base_no_decay 1-D parameters and biases: the backbone's lr, no decay
  base_decay    everything else: the backbone's lr, weight decay

Gradient accumulation (TrainConfig.grad_accum_steps = k > 1) has the
semantics of JAX's `optax.MultiSteps(every_k_schedule=k)`: each step()
folds the parameters' gradients into a running mean (Welford's update,
optax's), and every k-th applies AdamW to the mean and resets it; the other
steps leave the parameters as they are. `count` and the schedules count
updates, not micro-steps, and the mean carries across epoch boundaries.
The mean and the micro-step counter are in the optimizer's state_dict, with
`count`, so a checkpoint taken mid-cycle resumes exactly. Under DDP
(`process_group` set, by the train step) the micro-steps other than the
last fold their rank's own gradient, and the mean is averaged over the
group before the last one folds DDP's averaged gradient: the mean is
linear, so the update is the one-process update on the global batches
(`sync_accumulator` averages it at a checkpoint).

optax updates every parameter of a group, a zero gradient included (its
moments decay and weight decay shrinks it); torch's AdamW skips a
parameter without a `.grad`. So step() gives such a parameter a zero
gradient first: the unused predictors of a teacher-CLS student train as
they do in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
from torch.autograd.graph import increment_version

from dense2sparse_vit_torch.core.config import TrainConfig
from dense2sparse_vit_torch.parallel import group_size
from dense2sparse_vit_torch.train import schedule as sched

GROUPS = ("predictor", "early_exit", "base_decay", "base_no_decay")


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
        if "early_exit" in n:
            return "early_exit"
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
    baseline's recipe does. With cfg.grad_accum_steps > 1 it accumulates
    (module docstring); `steps_per_epoch` then counts updates an epoch.
    cfg.flat_optimizer (the default, as in JAX) takes torch's fused AdamW,
    which updates every parameter of a group in one launch (`fused=True`,
    JAX's `make_flat_optimizer`); False torch's default update, one tensor
    list per step of the rule (the multi-tensor `foreach` update on the
    card, a loop over the parameters on the CPU; JAX's per-leaf optax
    chain). The updates are the same to fp32 rounding."""

    def __init__(self, groups, cfg: TrainConfig, steps_per_epoch: int,
                 backbone_warmup_freeze: bool = True):
        # the flat optimizer: torch's fused AdamW, one launch over all of a
        # group's parameters (JAX's one raveled vector); else torch's default
        super().__init__(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=cfg.weight_decay,
                         fused=True if cfg.flat_optimizer else None)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.backbone_warmup_freeze = backbone_warmup_freeze
        self.count = 0
        self.accum_steps = cfg.grad_accum_steps
        self.mini_step = 0  # micro-steps folded into `accum` since the last update
        self.accum: Dict[torch.Tensor, torch.Tensor] = {}
        self.process_group = None  # DDP's data group (module docstring)

    def group_lr(self, label: str, epoch) -> float:
        if label in ("predictor", "early_exit"):
            return sched.predictor_lr(epoch, self.cfg)
        return sched.backbone_lr(epoch, self.cfg, warmup_freeze=self.backbone_warmup_freeze)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        for p in self._params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum_steps > 1:
            # optax MultiSteps: the running mean acc + (g - acc) / (n + 1)
            n = self.mini_step
            if n == self.accum_steps - 1:
                self.sync_accumulator()
            for p in self._params():
                if p.grad is None:
                    continue
                acc = self.accum.get(p)
                if acc is None:
                    acc = self.accum[p] = torch.zeros_like(p.grad)
                acc.add_((p.grad - acc) / (n + 1))
            self.mini_step = n + 1
            if self.mini_step < self.accum_steps:
                return None
            self.mini_step = 0
            grads = {p: p.grad for p in self.accum}
            for p, acc in self.accum.items():
                p.grad = acc
        epoch = self.count // self.steps_per_epoch
        for group in self.param_groups:
            group["lr"] = float(self.group_lr(group["label"], epoch))
        loss = super().step(closure)
        if self.defaults["fused"]:
            # the fused kernel writes the parameters without bumping their
            # version counters, by which the blocks' cached bf16 copies
            # (`nn.layers.compute_weights`) see a change
            for p in self._params():
                increment_version(p)
        self.count += 1
        if self.accum_steps > 1:
            for p, g in grads.items():
                p.grad = g
            self.accum = {}
        return loss

    @torch.no_grad()
    def sync_accumulator(self) -> None:
        """Average the running mean of the gradients over `process_group`
        (every rank calls it); nothing with one rank."""
        n = group_size(self.process_group)
        if n == 1 or not self.accum:
            return
        accs = list(self.accum.values())
        flat = torch.cat([a.reshape(-1) for a in accs])
        torch.distributed.all_reduce(flat, group=self.process_group)
        flat /= n
        at = 0
        for a in accs:
            a.copy_(flat[at:at + a.numel()].view_as(a))
            at += a.numel()

    def state_dict(self):
        sd = super().state_dict()
        params = self._params()
        sd["schedule"] = {
            "count": self.count, "mini_step": self.mini_step,
            "accum": {i: self.accum[p].clone() for i, p in enumerate(params) if p in self.accum},
        }
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        sched_state = state_dict.pop("schedule")
        super().load_state_dict(state_dict)
        params = self._params()
        self.count = int(sched_state["count"])
        self.mini_step = int(sched_state["mini_step"])
        self.accum = {params[int(i)]: a.to(params[int(i)].device).clone()
                      for i, a in sched_state["accum"].items()}


def make_optimizer(model: nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                   backbone_warmup_freeze: bool = True) -> ScheduledAdamW:
    """AdamW over `model`'s parameters in the groups of `label_params`.
    backbone_warmup_freeze=False: the backbone trains from epoch 0 (the gumbel
    baseline; JAX `make_optimizer`'s switch of the same name)."""
    labels = label_params(model)
    params = dict(model.named_parameters())
    wd = {"predictor": cfg.weight_decay, "early_exit": cfg.weight_decay,
          "base_decay": cfg.weight_decay, "base_no_decay": 0.0}
    groups = []
    for g in GROUPS:
        members = [params[n] for n, lbl in labels.items() if lbl == g]
        if members:
            groups.append({"params": members, "label": g, "weight_decay": wd[g]})
    return ScheduledAdamW(groups, cfg, steps_per_epoch, backbone_warmup_freeze)
