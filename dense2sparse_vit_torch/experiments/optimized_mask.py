"""Direct optimisation of per-patch mask logits (port of
`dense2sparse_vit_tpu/experiments/optimized_mask.py`).

A frozen `MaskedDistilledDeiT` student and a frozen `DistilledDeiT` teacher;
the (N, 2) keep / drop logits, Xavier-normal, are the only trainable
tensor. Each epoch their hard Gumbel decisions zero the dropped tokens from
block `mask_block` on, and the logits take one step of SGD(lr 1, momentum
0.5) under the StepLR rule (halved every 10 epochs) on `kd_loss`: the KL to
the teacher's fused logits (computed once), the CE and the keep-ratio
penalty. Every `viz_every` epochs the current keep mask is drawn.

On the card the blocks run as kernels in bf16: blocks 0 .. mask_block - 1
take the forward kernel alone (nothing there needs a gradient), blocks
mask_block .. depth - 1 the trainable one, whose backward kernel returns
the input's gradient; the frozen weights' gradients are not kept. Each
epoch's Gumbel noise comes from a generator seeded from (seed, epoch).

    python -m dense2sparse_vit_torch.experiments.optimized_mask \\
        --imgnet-val-dir DIR --epochs 40 --save-path OUT
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from dense2sparse_vit_torch.core.config import ModelConfig, deit_small
from dense2sparse_vit_torch.experiments.common import entry_device, model_kwargs
from dense2sparse_vit_torch.losses.distill import kd_loss
from dense2sparse_vit_torch.models.deit import DistilledDeiT, MaskedDistilledDeiT
from dense2sparse_vit_torch.viz.attention_segmentation import display_patch_drop


def sgd_step_lr(params, lr: float = 1.0, momentum: float = 0.5, step_size: int = 10,
                gamma: float = 0.5, steps_per_epoch: int = 1):
    """(optimizer, scheduler): SGD with momentum and the StepLR rule, lr *
    gamma ** ((count // steps_per_epoch) // step_size) at update `count`
    (call the scheduler's step() after each update). optax's trace, m <- g
    + momentum m and p <- p - lr m, is torch's SGD with dampening 0 and
    nesterov off (its first buffer is g itself, optax's g + momentum 0)."""
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0, nesterov=False)
    return opt, torch.optim.lr_scheduler.StepLR(opt, step_size * steps_per_epoch, gamma)


def standard_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """fp32 standard normals from `generator` (on the CPU), the mask
    logits' init before its Xavier scale."""
    return torch.randn(shape, generator=generator, dtype=torch.float32)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s Gumbel generator."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def _frozen(model: torch.nn.Module, state: Optional[Mapping], seed: int, device):
    if state is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                               else v for k, v in state.items()})
    return model.to(device).eval().requires_grad_(False)


def run_optimized_mask(images, labels, num_epochs: int = 40, cfg: Optional[ModelConfig] = None,
                       student_params: Optional[Mapping] = None,
                       teacher_params: Optional[Mapping] = None, temperature: float = 1.0,
                       seed: int = 212, save_dir: Optional[str] = None, viz_every: int = 10,
                       mask_block: int = 7, device=None):
    """Optimise the mask logits for one fixed batch of normalised (B, H, W,
    3) images and their (B,) labels (tensors or arrays).

    cfg: the DeiT configuration, deit_small by default (bf16 through the
    kernels on the card, fp32 on the CPU). student_params /
    teacher_params: state_dicts; seeded random weights where None. device:
    the card by default (it raises without one), "cpu" for the CPU.
    Returns (mask_logits, history), history a list of each epoch's metrics:
    kd_loss's, `acc` and `teacher_agreement`."""
    device = entry_device(device, "run_optimized_mask")
    cfg = cfg or deit_small(**model_kwargs(device))
    images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
    images = images.to(device)
    labels = torch.as_tensor(np.asarray(labels) if not torch.is_tensor(labels) else labels)
    labels = labels.to(device).long()
    student = _frozen(MaskedDistilledDeiT(cfg, mask_block=mask_block), student_params, seed,
                      device)
    teacher = _frozen(DistilledDeiT(cfg), teacher_params, seed + 2, device)

    n_patches = (images.shape[1] // cfg.patch_size) * (images.shape[2] // cfg.patch_size)
    # Xavier-normal (N, 2) logits: std sqrt(2 / (fan_in + fan_out))
    init = standard_normal((n_patches, 2), torch.Generator().manual_seed(seed + 3))
    mask_logits = (init * np.sqrt(2.0 / (n_patches + 2))).to(device).requires_grad_(True)

    with torch.no_grad():  # the teacher's fused logits, once
        t_cls, t_dist = teacher(images)
        t_logits = ((t_cls.float() + t_dist.float()) / 2)

    opt, sched = sgd_step_lr([mask_logits])
    gen = torch.Generator(device=device)
    history = []
    for epoch in range(num_epochs):
        gen.manual_seed(epoch_seed(seed, epoch))
        s_cls, s_dist, keep = student(images, mask_logits, generator=gen)
        s_logits = (s_cls.float() + s_dist.float()) / 2
        loss, metrics = kd_loss(s_logits, t_logits, labels, keep[..., 0], epoch,
                                temperature=temperature)
        pred = s_logits.argmax(-1)
        metrics["acc"] = (pred == labels).float().mean()
        metrics["teacher_agreement"] = (pred == t_logits.argmax(-1)).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        history.append({k: v.detach().item() for k, v in metrics.items()})
        if save_dir and (epoch % viz_every == 0 or epoch == num_epochs - 1):
            keep_now = (torch.softmax(mask_logits.detach(), -1)[:, 0] > 0.5).float().cpu()
            display_patch_drop(
                images.float().cpu().numpy(),
                np.broadcast_to(keep_now.numpy()[None], (images.shape[0], n_patches)),
                os.path.join(save_dir, f"optimized_mask_epoch_{epoch}.png"),
                patch_size=cfg.patch_size)
    return mask_logits.detach(), history


def main(argv=None):
    import argparse

    from dense2sparse_vit_torch.core.config import DataConfig
    from dense2sparse_vit_torch.data import ImageFolder, eval_transform

    p = argparse.ArgumentParser(description="Optimize per-patch mask logits for one fixed batch")
    p.add_argument("--imgnet-val-dir", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--save-path", default="test_imgs/")
    p.add_argument("--viz-every", type=int, default=10)
    p.add_argument("--mask-block", type=int, default=7)
    p.add_argument("--seed", type=int, default=212)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    ds = ImageFolder(args.imgnet_val_dir, eval_transform(DataConfig()))
    pairs = [ds[i] for i in range(min(len(ds), args.batch_size))]
    images = np.stack([im for im, _ in pairs])
    labels = np.array([y for _, y in pairs])
    os.makedirs(args.save_path, exist_ok=True)
    _, history = run_optimized_mask(images, labels, num_epochs=args.epochs, seed=args.seed,
                                    save_dir=args.save_path, viz_every=args.viz_every,
                                    mask_block=args.mask_block, device=args.device)
    for epoch, metrics in enumerate(history):
        line = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"epoch {epoch}: {line}")
    return history


if __name__ == "__main__":
    main()
