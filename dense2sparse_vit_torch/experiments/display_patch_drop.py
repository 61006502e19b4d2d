"""The attention-based patch-drop study (port of
`dense2sparse_vit_tpu/experiments/display_patch_drop.py`).

A DINO or DeiT model's last-block CLS attention (or, with
`use_shape_token` on a two-extra-token model, the distillation token's)
ranks the patches; {10..90}% of the attention mass is dropped from the
foreground (the most attended patches) and from the background (the least),
and each drop is written as an image grid, `{fg,bg}_drop_{rate}.png`.
On the card the CLS rows come from the block kernel's CLS-row mode
(`ops.fused_transformer_block_cls`, the model's `return_selfattention`).

    python -m dense2sparse_vit_torch.experiments.display_patch_drop \\
        --model-name dino_small --input-dir DIR --save-path OUT
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch
from PIL import Image

from dense2sparse_vit_torch.viz.attention_segmentation import (
    denormalize,
    generate_patch_mask,
    save_image_grid,
)

DROP_RATES = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


class UnlabeledImageFolder:
    """A flat folder of images, no class structure, in sorted order."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.files = sorted(f for f in os.listdir(root)
                            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")))
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        img = Image.open(os.path.join(self.root, self.files[i])).convert("RGB")
        return self.transform(img) if self.transform else img


def attention_keep_mask(cls_attn: np.ndarray, drop_rate: float, foreground: bool) -> np.ndarray:
    """(B, N) keep mask (float32) dropping `drop_rate` of each row's
    attention mass from its most attended patches (foreground) or its
    least attended (background): the patches whose cumulative share, in
    that order, is at most drop_rate."""
    a = np.asarray(cls_attn)
    a = a / a.sum(-1, keepdims=True)
    B, N = a.shape
    order = np.argsort(-a if foreground else a, axis=-1)
    sorted_vals = np.take_along_axis(a, order, axis=-1)
    cum = np.cumsum(sorted_vals, axis=-1)
    total = cum[:, -1:]
    drop_sorted = cum <= drop_rate * total
    keep = np.ones((B, N), bool)
    np.put_along_axis(keep, order, ~drop_sorted, axis=-1)
    return keep.astype(np.float32)


def _shape_token_rows(model, images: torch.Tensor, row: int = 1) -> torch.Tensor:
    """The last block's (B, H, N + extra) attention row of token `row` (1:
    the distillation token, which the CLS-row kernel does not give): the
    blocks but the last, then the last block's LN1, qkv product and that
    row's fp32 softmax."""
    x = model._embed(images)
    for blk in model.blocks[:-1]:
        x = blk(x)
    blk = model.blocks[-1]
    qkv = blk.attn.qkv(blk.norm1(x))
    B, N, C3 = qkv.shape
    H = blk.attn.num_heads
    q, k = qkv.view(B, N, 3, H, C3 // 3 // H).permute(2, 0, 3, 1, 4)[:2]
    s = torch.matmul(q[:, :, row:row + 1].float(), k.float().transpose(-1, -2)) * blk.attn.scale
    return torch.softmax(s, dim=-1)[:, :, 0]


@torch.no_grad()
def attention_scores(model, images: torch.Tensor, use_shape_token: bool = False,
                     mean_heads: bool = True) -> np.ndarray:
    """(B, N) host fp32 attention over the spatial tokens, renormalised:
    the CLS row of the model's last block (`return_selfattention`) or, with
    use_shape_token on a model with two extra tokens, the distillation
    token's; mean (or max) over the heads."""
    n_extra = getattr(model, "num_extra_tokens", 1)
    if use_shape_token and n_extra == 2:
        attn = _shape_token_rows(model, images)
    else:
        attn = model(images, return_selfattention=True)
    agg = attn.float().mean(1) if mean_heads else attn.float().amax(1)
    spatial = agg[:, n_extra:].cpu().numpy()
    return spatial / spatial.sum(-1, keepdims=True)


def patch_drop_masks(spatial: np.ndarray, drop_rates=DROP_RATES) -> dict:
    """{(foreground, rate): (B, N) keep mask} at every rate, both ways."""
    return {(fg, rate): attention_keep_mask(spatial, rate, foreground=fg)
            for fg in (True, False) for rate in drop_rates}


def generate_patch_drop_masked_image(model, images: torch.Tensor, save_dir: str,
                                     patch_size: int = 16, drop_rates=DROP_RATES,
                                     use_shape_token: bool = False,
                                     mean_heads: bool = True) -> List[str]:
    """Write the foreground and background patch-drop grids of the
    normalised (B, H, W, 3) `images` at each drop rate; returns the paths.

    model: a DeiT / DINO family module taking `return_selfattention=True`
    (-> the (B, H, N + extra) CLS rows), in eval mode."""
    spatial = attention_scores(model, images, use_shape_token, mean_heads)
    imgs = denormalize(images.float().cpu().numpy())
    written = []
    for (fg, rate), keep in patch_drop_masks(spatial, drop_rates).items():
        masked = imgs * generate_patch_mask(keep, patch_size)
        name = f"{'fg' if fg else 'bg'}_drop_{int(rate * 100)}.png"
        written.append(save_image_grid(
            masked, os.path.join(save_dir, name),
            suptitle=f"{'foreground' if fg else 'background'} drop {rate:.0%}"))
    return written


def load_panel(input_dir: str, batch_size: int, device) -> torch.Tensor:
    """The first batch_size images of a flat folder through the eval
    transform, normalised, as one (B, 224, 224, 3) tensor on `device`."""
    from dense2sparse_vit_torch.core.config import DataConfig
    from dense2sparse_vit_torch.data import eval_transform

    ds = UnlabeledImageFolder(input_dir, eval_transform(DataConfig()))
    batch = np.stack([ds[i] for i in range(min(len(ds), batch_size))])
    return torch.from_numpy(batch).to(device)


def main(argv=None):
    import argparse

    from dense2sparse_vit_torch.experiments.common import entry_device, model_kwargs
    from dense2sparse_vit_torch.models import create_model

    p = argparse.ArgumentParser(description="attention-based patch-drop grids")
    p.add_argument("--model-name", default="dino_small")
    p.add_argument("--patch-size", type=int, default=16)
    p.add_argument("--use-shape", action="store_true", default=False)
    p.add_argument("--input-dir", default="test_imgs/input/custom/")
    p.add_argument("--save-path", default="test_imgs/")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    device = entry_device(args.device, "display_patch_drop")
    model = create_model(args.model_name, patch_size=args.patch_size, device=device,
                         **model_kwargs(device)).eval()
    batch = load_panel(args.input_dir, args.batch_size, device)
    files = generate_patch_drop_masked_image(model, batch, args.save_path,
                                             patch_size=args.patch_size,
                                             use_shape_token=args.use_shape)
    print("\n".join(files))
    return files


if __name__ == "__main__":
    main()
