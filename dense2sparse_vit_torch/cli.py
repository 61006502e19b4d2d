"""Command-line interface: the flag surface -> the typed config -> the
training loop (port of `dense2sparse_vit_tpu/cli.py`).

    python -m dense2sparse_vit_torch.cli --imgnet-val-dir DIR [flags]

Every flag of the JAX package's CLI is accepted with its name and default,
plus --device (the card by default; `cpu` to run there); --use-dp and
--use-ddp are inert, as in the JAX package.

More than one process: launch one a device with torchrun, which sets the
rank and the rendezvous,

    torchrun --nproc_per_node N -m dense2sparse_vit_torch.cli --imgnet-val-dir DIR ...

or start each by hand with --dist-coordinator host:port
--dist-num-processes N --dist-process-id i. Every process joins the group
(NCCL on the card, gloo with --device cpu) before the loop; --device names
the device type and the rank picks its card (cuda:LOCAL_RANK).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from dense2sparse_vit_torch.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    PruningConfig,
    TrainConfig,
    deit_base,
    deit_small,
    deit_tiny,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dense2sparse-vit (PyTorch + CUDA port)")
    p.add_argument("--arch", default="deit_small", type=str)
    p.add_argument("--is-sbatch", action="store_true", default=False)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--save-path", default="test_imgs/")
    p.add_argument("--model-name", type=str, default="deit_small_patch16_224")
    p.add_argument("--patch-size", default=16, type=int)
    p.add_argument("--use-shape", action="store_true", default=False)
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--epochs", default=25, type=int)
    p.add_argument("--use-dp", action="store_true", default=False,
                   help="inert: for data parallelism launch one process a device with "
                   "torchrun --nproc_per_node N -m dense2sparse_vit_torch.cli")
    p.add_argument("--use-ddp", action="store_true", default=False,
                   help="inert: for data parallelism launch one process a device with "
                   "torchrun --nproc_per_node N -m dense2sparse_vit_torch.cli")
    p.add_argument("--imgnet-val-dir", type=str, default="/data/imagenet/val")
    # optimizer
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--warmup-steps", default=5, type=int,
                   help="epochs with the backbone frozen (the predictors train alone)")
    # pruning
    p.add_argument("--early-exit", action="store_true", default=False)
    p.add_argument("--pruning-locs", nargs="+", default=[3], type=int)
    p.add_argument("--keep-ratios", nargs="+", default=[0.3], type=float)
    p.add_argument("--softmax-temp", default=1.0, type=float)
    p.add_argument("--use-ratio-loss", action="store_true", default=False)
    p.add_argument("--ratio-weight", default=2.0, type=float)
    p.add_argument("--use-token-dist-loss", action="store_true", default=False)
    p.add_argument("--dist-weight", default=0.5, type=float)
    p.add_argument("--teacher-cls-loss", action="store_true", default=False)
    p.add_argument(
        "--teacher-cache", action="store_true", default=False,
        help="precompute the frozen teacher's outputs once and skip its forward every step. "
        "TRADE-OFF: a sample's teacher input must be the same every epoch, so training "
        "switches to the eval view: NO RandomResizedCrop/flip/RandAugment/RandomErasing "
        "(and mixup/cutmix must be disabled). Use it for throughput work, not for "
        "accuracy-parity runs",
    )
    p.add_argument("--device-cache-gb", default=6.0, type=float,
                   help="device memory budget of the teacher cache and the kept val batches")
    p.add_argument("--cls-weight", default=1.0, type=float)
    p.add_argument("--dynamic-vit-baseline", action="store_true", default=False,
                   help="train the DynamicViT-paper gumbel baseline student instead of the "
                   "diff-pruning student")
    p.add_argument("--topk-selection", action="store_true", default=False)
    p.add_argument("--mean-heads", action="store_true", default=False)
    p.add_argument("--random-drop", action="store_true", default=False)
    p.add_argument("--initial-sigma", default=0.05, type=float,
                   help="soft top-k's noise std at epoch 0 (differentiable_topk students)")
    p.add_argument("--attn-selection", action="store_true", default=False)
    p.add_argument("--cls-from-teacher", action="store_true", default=False)
    p.add_argument("--freeze-backbone", action="store_true", default=False)
    p.add_argument("--visualize-patch-drop", action="store_true", default=False)
    p.add_argument("--visualize-cls-attn-evo", action="store_true", default=False)
    p.add_argument("--small-predictor", action="store_true", default=False)
    p.add_argument("--mask-loss-type", default="kl_div", type=str)
    p.add_argument("--predictor-bn", action="store_true", default=False)
    p.add_argument("--patch-score-threshold", default=None, type=float)
    # augmentation
    p.add_argument("--color-jitter", type=float, default=0.4)
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--train-interpolation", type=str, default="bicubic")
    p.add_argument("--repeated-aug", action="store_true")
    p.add_argument("--no-repeated-aug", action="store_false", dest="repeated_aug")
    p.set_defaults(repeated_aug=True)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", type=str, default="pixel")
    p.add_argument("--recount", type=int, default=1)
    p.add_argument("--resplit", action="store_true", default=False)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", type=str, default="batch")
    # geometry for small runs
    p.add_argument("--img-size", default=224, type=int)
    p.add_argument("--num-classes", default=1000, type=int)
    p.add_argument("--eval-resize", default=256, type=int)
    p.add_argument("--eval-crop", default=224, type=int)
    p.add_argument("--use-fused-attention", action="store_true", default=False,
                   help="run the blocks, predictors and gathers through the CUDA kernels")
    # int8 PTQ serving (eval, --eval-only and export; training stays in the
    # compute dtype); needs --use-fused-attention
    p.add_argument("--quant", default="none", choices=["none", "int8"])
    p.add_argument("--grad-accum-steps", default=1, type=int,
                   help="average the gradients of this many micro-steps into each update "
                   "(effective batch = batch-size * k)")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--flat-optimizer", action="store_true",
                   help="AdamW as torch's fused step, one launch over each parameter group "
                   "(the default)")
    p.add_argument("--no-flat-optimizer", action="store_false", dest="flat_optimizer",
                   help="AdamW as torch's default step (multi-tensor on the card)")
    p.set_defaults(flat_optimizer=True)
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute the student's forward in the backward instead of keeping "
                   "its activations (ignored with --predictor-bn)")
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--workdir", type=str, default="runs/latest")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--eval-only", action="store_true", default=False,
                   help="restore the workdir's checkpoint and run one padded "
                   "full-coverage eval")
    p.add_argument("--report-flops", action="store_true", default=False)
    p.add_argument("--export-serving", type=str, default=None, metavar="DIR",
                   help="after training (or with --eval-only) save ServingModel artifacts "
                   "of the best checkpoint")
    p.add_argument("--dist-coordinator", type=str, default=None,
                   help="host:port of rank 0 for multi-process training (else torchrun's "
                   "MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device type: the card (default; each rank its own) or the CPU")
    return p


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    """Map the parsed flags onto the typed config."""
    sizes = {"deit_tiny": deit_tiny, "deit_small": deit_small, "deit_base": deit_base}
    if args.arch not in sizes:
        raise ValueError(f"unknown arch {args.arch!r}; options {sorted(sizes)}")
    if args.eval_crop != args.img_size:
        # the transforms emit eval_crop-sized images; the position embedding
        # is sized for img_size
        raise ValueError(f"--eval-crop ({args.eval_crop}) must equal --img-size "
                         f"({args.img_size}): the model consumes eval-crop-sized inputs")
    model: ModelConfig = sizes[args.arch](
        img_size=args.img_size, patch_size=args.patch_size, num_classes=args.num_classes,
        dtype=args.dtype, use_fused_attention=args.use_fused_attention, quant=args.quant,
        remat=args.remat)
    if args.dynamic_vit_baseline:
        selection = "gumbel"
    elif args.attn_selection:
        selection = "attn"
    elif args.random_drop:
        selection = "random"
    else:  # --topk-selection, and the default
        selection = "topk"
    pruning = PruningConfig(
        pruning_locs=tuple(args.pruning_locs),
        keep_ratios=tuple(args.keep_ratios),
        selection=selection,
        patch_score_threshold=args.patch_score_threshold,
        small_predictor=args.small_predictor,
        predictor_bn=args.predictor_bn,
        mask_loss_type=args.mask_loss_type,
        initial_sigma=args.initial_sigma,
        mean_heads=args.mean_heads,
        cls_from_teacher=args.cls_from_teacher,
        early_exit=args.early_exit,
    )
    train = TrainConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        warmup_lr=args.warmup_lr,
        min_lr=args.min_lr,
        weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_steps,
        freeze_backbone=args.freeze_backbone,
        softmax_temp=args.softmax_temp,
        use_ratio_loss=args.use_ratio_loss,
        ratio_weight=args.ratio_weight,
        use_token_dist_loss=args.use_token_dist_loss,
        dist_weight=args.dist_weight,
        cls_weight=args.cls_weight,
        teacher_cls_loss=args.teacher_cls_loss,
        teacher_cache=args.teacher_cache,
        device_cache_gb=args.device_cache_gb,
        grad_accum_steps=args.grad_accum_steps,
        flat_optimizer=args.flat_optimizer,
        seed=args.seed,
    )
    data = DataConfig(
        imgnet_val_dir=args.imgnet_val_dir,
        num_classes=args.num_classes,
        eval_resize=args.eval_resize,
        eval_crop=args.eval_crop,
        color_jitter=args.color_jitter,
        auto_augment=args.aa,
        smoothing=args.smoothing,
        train_interpolation=args.train_interpolation,
        repeated_aug=args.repeated_aug,
        reprob=args.reprob,
        remode=args.remode,
        recount=args.recount,
        mixup=args.mixup,
        cutmix=args.cutmix,
        cutmix_minmax=tuple(args.cutmix_minmax) if args.cutmix_minmax else None,
        mixup_prob=args.mixup_prob,
        mixup_switch_prob=args.mixup_switch_prob,
        mixup_mode=args.mixup_mode,
    )
    return ExperimentConfig(
        arch=args.arch, model=model, pruning=pruning, train=train, data=data,
        save_path=args.save_path, wandb=args.wandb,
        visualize_patch_drop=args.visualize_patch_drop,
        visualize_cls_attn_evo=args.visualize_cls_attn_evo,
    )


def parse_config(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    return args_to_config(args), args


def main(argv: Optional[Sequence[str]] = None):
    from dense2sparse_vit_torch.train.loop import run_experiment

    import torch

    from dense2sparse_vit_torch.core.mesh import distributed, maybe_initialize_distributed

    cfg, args = parse_config(argv)
    if args.use_ddp or args.use_dp:
        print("note: --use-ddp/--use-dp are inert: for data parallelism launch one process a "
              "device, torchrun --nproc_per_node N -m dense2sparse_vit_torch.cli ...")
    joined = not distributed() and maybe_initialize_distributed(
        args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
        device_type=args.device)
    try:
        return run_experiment(
            cfg, args.workdir,
            resume=args.resume or args.eval_only,
            eval_only=args.eval_only,
            report_flops=args.report_flops,
            export_serving=args.export_serving,
            device=args.device,
        )
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
