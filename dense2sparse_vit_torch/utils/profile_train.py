"""Where the device time of the headline student's train step goes, by kernel.

    python -m dense2sparse_vit_torch.utils.profile_train [--batch 128] [--plain]
        [--mode topk|threshold|attn|gumbel|t2t]

Builds `dynamic_vit_small_patch16_224_student` (bf16, keep 0.7/0.49/0.343 at
blocks 3/6/9, small predictor; `--mode threshold`: in threshold mode;
`--mode attn`: ranking by its own CLS rows, no predictors) and
its teacher with random weights, AdamW past the warmup and
`make_train_step` (`--mode gumbel`: the gumbel baseline at the same ratios
with `make_dynamic_vit_train_step` and its ratio and token-distillation
losses; `--mode t2t`: the pruned T2T-ViT-14 at drop path 0.1 with the
teacher the JAX loop pairs with it, a `ViTTeacher` of its ModelConfig),
runs `--iters` steps at epoch 6 under
`torch.profiler` on the first CUDA device, and prints one JSON line per
device kernel (calls and ms per step, share of the device time), then a
summary line with the wall time per step, the device's busy share and the
host's time to enqueue one step. `--plain` profiles the models without the
hand-written kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import HEADLINE_TEACHER, ViTTeacher, create_model
from dense2sparse_vit_torch.train import (
    make_dynamic_vit_train_step, make_optimizer, make_train_step)
from dense2sparse_vit_torch.utils.profile_forward import MODES, profile_device

EPOCH = 6
STEPS_PER_EPOCH = 10
T2T_DROP_PATH = 0.1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--mode", choices=sorted(MODES), default="topk")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda", 0)
    fused = not args.plain
    name, kwargs = MODES[args.mode]
    if args.mode == "t2t":
        student = create_model(name, use_fused_attention=fused, device=dev,
                               drop_path_rate=T2T_DROP_PATH, **kwargs)
        teacher = ViTTeacher(student.cfg).init_weights(torch.Generator().manual_seed(1)).to(dev)
    else:
        student = create_model(name, use_fused_attention=fused, device=dev, **kwargs)
        teacher = create_model(HEADLINE_TEACHER, use_fused_attention=fused, device=dev,
                               dtype="bfloat16")
    gumbel = args.mode == "gumbel"
    train = TrainConfig(use_ratio_loss=gumbel, use_token_dist_loss=gumbel)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=train)
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH, backbone_warmup_freeze=not gumbel)
    opt.count = cfg.train.warmup_epochs * STEPS_PER_EPOCH
    make = make_dynamic_vit_train_step if gumbel else make_train_step
    step = make(student, teacher, opt, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    labels = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    summary = profile_device(lambda: step(x, labels, EPOCH), args.iters)
    print(json.dumps({"batch": args.batch, "mode": args.mode, "plain": args.plain, **summary,
                      "img_per_s": args.batch / summary["wall_ms"] * 1e3}))


if __name__ == "__main__":
    main()
