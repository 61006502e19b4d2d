"""One-command top-1 parity report: the reference's torch student against
the port (port of `dense2sparse_vit_tpu/experiments/parity_report.py`).

It builds the reference's own `VisionTransformerDiffPruning` from the
model code in `--reference-dir` (the release's `vit_models/`, loaded
through `utils.reference_loader`'s timm shim), loads the checkpoint into it
with strict=False, and loads the MERGED state_dict (the checkpoint's
tensors and the reference's init for any key it lacks) into the port's
student, whose key layout is the reference's: both sides run the same
weights even from a dense or partial checkpoint. Both then evaluate the
same eval-transform batches; the report gives each side's pruned and
unpruned top-1 and the deltas (the port's fields are JAX's `flax_*` as
`port_*`).

The reference runs on the CPU; the port on the card (bf16 through the
kernels) unless device="cpu" (fp32, or the `dtype` given). The reference
code is not part of this repository: where --reference-dir does not exist
the report raises FileNotFoundError naming it.

    python -m dense2sparse_vit_torch.experiments.parity_report \\
        --ref-ckpt dynamic_vit_deit_small.pth --reference-dir vit_models \\
        --imgnet-val-dir /data/imagenet/val --max-batches 40
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dense2sparse_vit_torch.core.config import (
    DataConfig,
    PruningConfig,
    deit_base,
    deit_small,
    deit_tiny,
)
from dense2sparse_vit_torch.data import ImageFolder, eval_transform, make_loader
from dense2sparse_vit_torch.experiments.common import entry_device, model_kwargs

_SIZES = {"deit_tiny": deit_tiny, "deit_small": deit_small, "deit_base": deit_base}
REFERENCE_DIR = "reference/vit_models"


def _load_reference_student(arch, pruning_locs, keep_ratios, ckpt_path, small_predictor,
                            predictor_bn, mask_loss_type, reference_dir):
    """(model, merged state_dict): the reference torch student with the
    checkpoint merged in, on the CPU in eval mode. The one seam to the
    reference: the model is called on NCHW images and returns a tuple whose
    first entry is the logits, and has an `unpruned` attribute."""
    from dense2sparse_vit_torch.utils.reference_loader import load_reference_module

    ref = load_reference_module("dynamic_vit", reference_dir)
    cfg = _SIZES[arch]()
    torch.manual_seed(0)
    model = ref.VisionTransformerDiffPruning(
        img_size=cfg.img_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
        depth=cfg.depth, num_heads=cfg.num_heads, num_classes=cfg.num_classes,
        pruning_loc=list(pruning_locs), token_ratio=list(keep_ratios), topk_selection=True,
        predictor_loss_type=mask_loss_type, small_predictor=small_predictor,
        predictor_bn=predictor_bn)
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "model_state_dict", "state_dict_ema", "state_dict"):
        if wrapper in sd and not hasattr(sd[wrapper], "shape"):
            sd = sd[wrapper]
            break
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    model.eval()
    print(f"checkpoint: {len(sd)} tensors, {len(missing)} missing (kept at torch init), "
          f"{len(unexpected)} unexpected (ignored)")
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def parity_report(arch="deit_small", ref_ckpt=None, imgnet_val_dir="/data/imagenet/val",
                  pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343), batch_size=64,
                  max_batches=40, small_predictor=False, predictor_bn=False,
                  mask_loss_type="kl_div", dtype=None, num_workers=0,
                  reference_dir=REFERENCE_DIR, device=None) -> dict:
    """The report (a dict, also printed as JSON). dtype: the port's compute
    dtype, by default bf16 on the card and fp32 on the CPU."""
    device = entry_device(device, "parity_report")
    ref_model, sd_full = _load_reference_student(
        arch, pruning_locs, keep_ratios, ref_ckpt, small_predictor, predictor_bn,
        mask_loss_type, reference_dir)

    from dense2sparse_vit_torch.models import DiffPruningStudent

    kw = model_kwargs(device)
    if dtype is not None:
        kw["dtype"] = dtype
    student = DiffPruningStudent(_SIZES[arch](**kw), PruningConfig(
        pruning_locs=tuple(pruning_locs), keep_ratios=tuple(keep_ratios),
        small_predictor=small_predictor, predictor_bn=predictor_bn,
        mask_loss_type=mask_loss_type))
    sd = {k: torch.as_tensor(v) for k, v in sd_full.items() if "num_batches_tracked" not in k}
    missing, unexpected = student.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise RuntimeError(f"reference keys the port does not take: {list(unexpected)}; "
                           f"port keys the reference lacks: {list(missing)}")
    student.to(device).eval()
    print(f"port side: loaded {len(sd)} tensors")

    ds = ImageFolder(imgnet_val_dir, eval_transform(DataConfig(imgnet_val_dir=imgnet_val_dir)))
    loader = make_loader(ds, batch_size, drop_last=False, num_workers=num_workers,
                         pin_memory=True)
    counts = dict(ref_pruned=0, ref_dense=0, port_pruned=0, port_dense=0)
    total, max_logit_delta = 0, 0.0
    t0 = time.time()
    try:
        with torch.no_grad():
            for i, (xb, yb) in enumerate(loader(0)):
                if max_batches and i >= max_batches:
                    break
                y = yb.numpy()
                xt = xb.permute(0, 3, 1, 2).contiguous()
                r_logits = ref_model(xt)[0].numpy()
                # the reference eval sets model.unpruned, which its forward
                # never reads: its "unpruned" top-1 is a second pruned pass.
                # ref_dense keeps that behaviour, port_dense is the intent;
                # pruned_delta is the parity figure
                ref_model.unpruned = True
                r_dense = ref_model(xt)[0].numpy()
                ref_model.unpruned = False
                x = xb.to(device)
                p_logits = student(x, collect_cls_attns=False).logits.float().cpu().numpy()
                p_dense = student(x, unpruned=True,
                                  collect_cls_attns=False).logits.float().cpu().numpy()
                if i == 0:
                    max_logit_delta = float(np.abs(p_logits - r_logits).max())
                counts["ref_pruned"] += int((r_logits.argmax(-1) == y).sum())
                counts["ref_dense"] += int((r_dense.argmax(-1) == y).sum())
                counts["port_pruned"] += int((p_logits.argmax(-1) == y).sum())
                counts["port_dense"] += int((p_dense.argmax(-1) == y).sum())
                total += len(y)
    finally:
        loader.close()

    top1 = {k: v / max(total, 1) for k, v in counts.items()}
    report = {
        "arch": arch,
        "checkpoint": ref_ckpt,
        "images": total,
        "keep_ratios": list(keep_ratios),
        **{f"{k}_top1": round(v, 4) for k, v in top1.items()},
        "pruned_delta": round(top1["port_pruned"] - top1["ref_pruned"], 4),
        "dense_delta": round(top1["port_dense"] - top1["ref_dense"], 4),
        "first_batch_max_logit_delta": max_logit_delta,
        "seconds": round(time.time() - t0, 1),
    }
    print(json.dumps(report))
    within = abs(report["pruned_delta"]) <= 0.002
    print(f"BASELINE #1 (|pruned delta| <= 0.2%): {'PASS' if within else 'FAIL'}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="deit_small", choices=sorted(_SIZES))
    p.add_argument("--ref-ckpt", required=True)
    p.add_argument("--imgnet-val-dir", default="/data/imagenet/val")
    p.add_argument("--pruning-locs", nargs="+", type=int, default=[3, 6, 9])
    p.add_argument("--keep-ratios", nargs="+", type=float, default=[0.7, 0.49, 0.343])
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--max-batches", type=int, default=40,
                   help="0 = the whole val set (slow: the reference runs on the CPU)")
    p.add_argument("--small-predictor", action="store_true")
    p.add_argument("--predictor-bn", action="store_true")
    p.add_argument("--mask-loss-type", default="kl_div")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--reference-dir", default=REFERENCE_DIR,
                   help="the reference release's vit_models/ directory")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = p.parse_args(argv)
    return parity_report(
        arch=a.arch, ref_ckpt=a.ref_ckpt, imgnet_val_dir=a.imgnet_val_dir,
        pruning_locs=tuple(a.pruning_locs), keep_ratios=tuple(a.keep_ratios),
        batch_size=a.batch_size, max_batches=a.max_batches or None,
        small_predictor=a.small_predictor, predictor_bn=a.predictor_bn,
        mask_loss_type=a.mask_loss_type, num_workers=a.num_workers,
        reference_dir=a.reference_dir, device=a.device)


if __name__ == "__main__":
    main()
