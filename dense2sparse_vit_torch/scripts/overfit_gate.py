"""Overfit-one-batch acceptance gate of the port's trainer (on the card).

The port of `scripts/overfit_gate.py`: 400 steps of `make_train_step` on
one fixed batch of the DeiT-S 3-stage student (pruning at 3/6/9, keep
0.7/0.49/0.343, top-k, bf16, the fused kernels) with a random teacher must
overfit it: cross-entropy drops >= 8x, the total loss drops >= 4x, and the
final mask accuracy is >= 0.9 and no lower than the first. The thresholds
are the JAX gate's. They reflect the joint loss's equilibrium, not free
memorisation: the distillation KL pulls the student's logits toward a
teacher that does not know the random labels, so cross-entropy plateaus
(JAX measured 10.2x at 400 steps) and the total loss keeps its mask and
distillation floors (JAX: 5.7x). A broken optimization path sits far
below them (the production backbone-lr cap alone gives CE ~2x).

The batch is B = 32 images of N(0, 1) noise with random labels (no
dataset); the configuration is the gate's, not production's:
`warmup_epochs=0` (both losses from step 0), `epochs=10_000` (the cosine
stays near its base lr), `backbone_lr_scale=1.0` (the production cap at
lr * 0.01 cannot overfit a batch this fast: the gate tests the
optimization path, so the backbone gets the full lr). The per-step metrics
stay on the device and are read once at the end, as the JAX gate's
`lax.scan` keeps them.

Usage (on the card; `--device cpu` runs the same steps on the CPU, at the
gate's size slowly):

    python -m dense2sparse_vit_torch.scripts.overfit_gate

Prints one JSON line with the JAX gate's keys and exits 1 if the gate
fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch

B = 32
STEPS = 400
STUDENT = "dynamic_vit_small_patch16_224_student"
TEACHER = "dynamic_vit_small_patch16_224_teacher"
PRUNING = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343))
# the JAX gate's thresholds
CLS_LOSS_RATIO = 8.0
LOSS_RATIO = 4.0
MASK_ACC = 0.9


def gate(losses, cls_losses, mask_accs, steps: Optional[int] = None) -> dict:
    """The gate's verdict on per-step curves (sequences of floats): the JAX
    gate's JSON object, its "pass" true where cross-entropy fell >= 8x, the
    total loss >= 4x, and the last mask accuracy is >= 0.9 and no lower
    than the first."""
    first, last = float(losses[0]), float(losses[-1])
    first_ce, last_ce = float(cls_losses[0]), float(cls_losses[-1])
    first_macc, last_macc = float(mask_accs[0]), float(mask_accs[-1])
    ratio = first / max(last, 1e-9)
    ce_ratio = first_ce / max(last_ce, 1e-9)
    ok = (ce_ratio >= CLS_LOSS_RATIO and ratio >= LOSS_RATIO and last_macc >= MASK_ACC
          and last_macc >= first_macc - 1e-6)
    return {
        "gate": "overfit_one_batch",
        "steps": len(losses) if steps is None else steps,
        "first_loss": round(first, 4),
        "last_loss": round(last, 4),
        "loss_ratio": round(ratio, 2),
        "first_cls_loss": round(first_ce, 4),
        "last_cls_loss": round(last_ce, 4),
        "cls_loss_ratio": round(ce_ratio, 2),
        "first_mask_acc": round(first_macc, 4),
        "last_mask_acc": round(last_macc, 4),
        "pass": bool(ok),
    }


def build(device, *, batch: int = B, overrides: Optional[dict] = None,
          pruning: Optional[dict] = None, backbone_lr_scale: float = 1.0,
          dtype: str = "bfloat16", fused: bool = True, seed: int = 0):
    """(step, images, labels, student): the gate's student and random
    teacher (seeded weights; `overrides` of `create_model`'s widths, e.g. a
    shallower model for a test), its train step and its fixed batch."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    kw = dict(device=device, dtype=dtype, use_fused_attention=fused, **(overrides or {}))
    student = create_model(STUDENT, generator=torch.Generator().manual_seed(seed + 2),
                           **kw, **(pruning or PRUNING))
    teacher = create_model(TEACHER, generator=torch.Generator().manual_seed(seed + 3), **kw)
    cfg = ExperimentConfig(
        model=student.cfg, pruning=student.pruning,
        train=TrainConfig(batch_size=batch, epochs=10_000, warmup_epochs=0,
                          backbone_lr_scale=backbone_lr_scale))
    opt = make_optimizer(student, cfg.train, steps_per_epoch=1)
    step = make_train_step(student, teacher, opt, cfg)
    size = student.cfg.img_size
    gen = torch.Generator().manual_seed(seed)
    images = torch.randn((batch, size, size, 3), generator=gen).to(device, torch.bfloat16)
    labels = torch.randint(0, student.cfg.num_classes, (batch,), generator=gen).to(device)
    return step, images, labels, student


def run(device="cuda", *, steps: int = STEPS, **build_kw) -> dict:
    """`steps` train steps on the gate's one batch; the gate's verdict
    (`gate`). The metrics stay on the device until the last step."""
    step, images, labels, _ = build(torch.device(device), **build_kw)
    curves = []
    for i in range(steps):
        m = step(images, labels, 0.0,
                 generator=torch.Generator(device=images.device).manual_seed(4 + i))
        curves.append(torch.stack([m["loss"], m["cls_loss"],
                                   m.get("mask_acc_0", torch.zeros_like(m["loss"]))]))
    losses, ces, maccs = torch.stack(curves).float().cpu().T.tolist()
    return gate(losses, ces, maccs, steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("overfit_gate: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 2
    result = run(args.device, steps=args.steps)
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
