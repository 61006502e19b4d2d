"""ImageNet evaluation of one checkpoint (port of
`dense2sparse_vit_tpu/experiments/eval_imagenet.py`).

Pruned and unpruned top-1 of a student, or the top-1 of a plain backbone,
from a published torch checkpoint (.pth / .pth.tar), over every image of a
val folder:

  deit_tiny / deit_small / deit_base   the pruned student (a DeiT checkpoint
                                       has no predictor keys: the predictors
                                       keep their seeded init)
  t2t_vit_7/10/12/14/19/24, t2t_vit_t_14/19/24
                                       the plain T2T backbone
  dino_tiny / dino_small / dino_base   the plain DINO backbone (headless
                                       checkpoints: the head keeps its init)

The port's modules use the reference's torch key layout, so a checkpoint
loads with `load_state_dict(strict=False)`; a position embedding of another
grid is resized (`utils.convert.resize_pos_embed`), a legacy linear patch
projection reshaped to the convolution's. The loaded and skipped tensors
are reported.

The loader ships uint8 batches, normalised on the device; the tail batch is
padded to the batch size with label -1 and counts nowhere, and the result
asserts that every image was counted. The counts add up on the device and
are read once, at the end. On the card the model runs in bf16 through the
kernels; `device="cpu"` runs it on the CPU.

    python -m dense2sparse_vit_torch.experiments.eval_imagenet \\
        --imgnet-val-dir /data/imagenet/val \\
        --checkpoint deit_small_patch16_224-cd65a155.pth \\
        --keep-ratios 0.7 0.49 0.343 --pruning-locs 3 6 9
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Mapping, Optional

import numpy as np
import torch

from dense2sparse_vit_torch.core.config import (
    DataConfig,
    ModelConfig,
    PruningConfig,
    deit_base,
    deit_small,
    deit_tiny,
)
from dense2sparse_vit_torch.data import ImageFolder, device_normalize, eval_transform, make_loader
from dense2sparse_vit_torch.experiments.common import entry_device
from dense2sparse_vit_torch.utils.convert import resize_pos_embed

# T2T factory shapes: embed, depth, heads, mlp ratio, stem type
_T2T_SHAPES = {
    "t2t_vit_7": (256, 7, 4, 2.0, "performer"),
    "t2t_vit_10": (256, 10, 4, 2.0, "performer"),
    "t2t_vit_12": (256, 12, 4, 2.0, "performer"),
    "t2t_vit_14": (384, 14, 6, 3.0, "performer"),
    "t2t_vit_19": (448, 19, 7, 3.0, "performer"),
    "t2t_vit_24": (512, 24, 8, 3.0, "performer"),
    "t2t_vit_t_14": (384, 14, 6, 3.0, "transformer"),
    "t2t_vit_t_19": (448, 19, 7, 3.0, "transformer"),
    "t2t_vit_t_24": (512, 24, 8, 3.0, "transformer"),
}
# DINO backbone shapes: embed, depth, heads
_DINO_SHAPES = {
    "dino_tiny": (192, 12, 3),
    "dino_small": (384, 12, 6),
    "dino_base": (768, 12, 12),
}
_DEIT_SIZES = {"deit_tiny": deit_tiny, "deit_small": deit_small, "deit_base": deit_base}


def load_torch_checkpoint(path: str) -> dict:
    """A torch .pth / .pth.tar checkpoint as {key: CPU tensor}, unwrapped
    from its 'model', 'state_dict_ema' or 'state_dict' container."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict_ema", "state_dict"):
        if wrapper in sd and not hasattr(sd[wrapper], "shape"):
            sd = sd[wrapper]
            break
    return dict(sd)


def build_model(arch: str, pruning_locs, keep_ratios, dtype: str, use_fused_attention: bool):
    """(module, has_unpruned): the pruned student for a DeiT arch (with an
    unpruned pass), else the plain T2T or DINO backbone; weights seeded 0."""
    if arch in _DEIT_SIZES:
        from dense2sparse_vit_torch.models import DiffPruningStudent

        cfg = _DEIT_SIZES[arch](dtype=dtype, use_fused_attention=use_fused_attention)
        model = DiffPruningStudent(cfg, PruningConfig(pruning_locs=tuple(pruning_locs),
                                                      keep_ratios=tuple(keep_ratios)))
        has_unpruned = True
    elif arch in _T2T_SHAPES:
        from dense2sparse_vit_torch.models.t2t import T2TViT

        d, depth, heads, mlp, tokens_type = _T2T_SHAPES[arch]
        cfg = ModelConfig(embed_dim=d, depth=depth, num_heads=heads, mlp_ratio=mlp,
                          qkv_bias=False, layer_norm_eps=1e-5, dtype=dtype,
                          use_fused_attention=use_fused_attention)
        model, has_unpruned = T2TViT(cfg, tokens_type=tokens_type), False
    elif arch in _DINO_SHAPES:
        from dense2sparse_vit_torch.models.dino import DINOViT

        d, depth, heads = _DINO_SHAPES[arch]
        cfg = ModelConfig(embed_dim=d, depth=depth, num_heads=heads, qkv_bias=True,
                          layer_norm_eps=1e-6, dtype=dtype,
                          use_fused_attention=use_fused_attention)
        model, has_unpruned = DINOViT(cfg), False
    else:
        raise ValueError(f"unknown arch {arch!r}")
    model.init_weights(torch.Generator().manual_seed(0))
    return model, has_unpruned


def load_checkpoint_weights(model: torch.nn.Module, state_dict: Mapping):
    """Load a reference-layout state_dict into `model` (strict=False):
    DINO's training container ('teacher' -> 'backbone.*') unwrapped, a
    position embedding of another grid resized, a legacy linear patch
    projection reshaped. Returns (loaded, skipped) key lists: skipped are
    the keys the model lacks or holds at another shape."""
    sd = dict(state_dict)
    if "teacher" in sd and not hasattr(sd["teacher"], "shape"):
        sd = {k.removeprefix("backbone."): v for k, v in sd["teacher"].items()
              if k.startswith("backbone.")}
    own = model.state_dict()
    take, skipped = {}, []
    for key, v in sd.items():
        v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if key == "pos_embed" and key in own and v.shape != own[key].shape:
            n_extra = 2 if "dist_token" in sd else 1
            v = torch.from_numpy(resize_pos_embed(v.float().numpy(), own[key].shape[1], n_extra))
        if key.endswith("patch_embed.proj.weight") and key in own and v.dim() < 4:
            v = v.reshape(own[key].shape)
        if key in own and tuple(v.shape) == tuple(own[key].shape):
            take[key] = v
        else:
            skipped.append(key)
    model.load_state_dict(take, strict=False)
    return list(take), skipped


def evaluate(
    arch: str = "deit_small",
    imgnet_val_dir: str = "/data/imagenet/val",
    checkpoint: Optional[str] = None,
    pruning_locs=(3, 6, 9),
    keep_ratios=(0.7, 0.49, 0.343),
    batch_size: int = 128,
    max_batches: Optional[int] = None,
    dtype: str = "bfloat16",
    use_fused_attention: bool = True,
    num_workers: int = 0,
    device=None,
) -> dict:
    """Top-1 over the val folder; returns and prints the JAX function's
    fields. device: the card by default (it raises without one), "cpu"
    for the CPU."""
    device = entry_device(device, "evaluate")
    model, has_unpruned = build_model(arch, pruning_locs, keep_ratios, dtype,
                                      use_fused_attention)
    if checkpoint:
        loaded, skipped = load_checkpoint_weights(model, load_torch_checkpoint(checkpoint))
        print(f"loaded {len(loaded)} tensors, skipped {len(skipped)}")
    model.to(device).eval()

    data_cfg = DataConfig(imgnet_val_dir=imgnet_val_dir)
    # uint8 to the device (4x fewer bytes), normalised there
    ds = ImageFolder(imgnet_val_dir, eval_transform(data_cfg, normalize=False))
    # full coverage: the tail batch is kept (padded below), no image dropped
    loader = make_loader(ds, batch_size, drop_last=False, num_workers=num_workers,
                         as_uint8=True, pin_memory=True)

    def logits(images, unpruned=False):
        if has_unpruned:  # the student
            return model(images, unpruned=unpruned, collect_cls_attns=False).logits
        return model(images)

    counts = torch.zeros(3, dtype=torch.int64, device=device)  # pruned, unpruned, valid
    t0 = time.time()
    try:
        with torch.no_grad():
            for i, (xb, yb) in enumerate(loader(0)):
                if max_batches and i >= max_batches:
                    break
                if len(yb) < batch_size:  # pad the tail batch, label -1
                    pad = batch_size - len(yb)
                    xb = torch.cat([xb, xb.new_zeros((pad,) + tuple(xb.shape[1:]))])
                    yb = torch.cat([yb, torch.full((pad,), -1, dtype=yb.dtype)])
                x = device_normalize(xb.to(device, non_blocking=True), data_cfg)
                y = yb.to(device, non_blocking=True).long()
                valid = y >= 0
                c = ((logits(x).argmax(-1) == y) & valid).sum()
                cd = ((logits(x, True).argmax(-1) == y) & valid).sum() if has_unpruned else c
                counts += torch.stack([c, cd, valid.sum()])
        correct, correct_dense, total = (int(v) for v in counts.tolist())
    finally:
        loader.close()
    dt = time.time() - t0
    if max_batches is None and total != len(ds):
        raise AssertionError(f"eval covered {total} of {len(ds)} images: coverage bug")
    result = {
        "arch": arch,
        "pruned_top1": correct / max(total, 1),
        "unpruned_top1": correct_dense / max(total, 1),
        "images": total,
        "seconds": round(dt, 1),
        "keep_ratios": list(keep_ratios),
        "pruning_locs": list(pruning_locs),
        "checkpoint": checkpoint,
    }
    print(json.dumps(result))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="top-1 of one checkpoint over a val folder")
    p.add_argument("--arch", default="deit_small")
    p.add_argument("--imgnet-val-dir", default="/data/imagenet/val")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--pruning-locs", nargs="+", type=int, default=[3, 6, 9])
    p.add_argument("--keep-ratios", nargs="+", type=float, default=[0.7, 0.49, 0.343])
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    return evaluate(
        arch=args.arch, imgnet_val_dir=args.imgnet_val_dir, checkpoint=args.checkpoint,
        pruning_locs=args.pruning_locs, keep_ratios=args.keep_ratios,
        batch_size=args.batch_size, max_batches=args.max_batches,
        dtype="bfloat16" if on_card else "float32", use_fused_attention=on_card,
        num_workers=args.num_workers, device=args.device,
    )


if __name__ == "__main__":
    main()
