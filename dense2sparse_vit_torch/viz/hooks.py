"""The epoch-end visualization hook (port of `dense2sparse_vit_tpu/viz/hooks.py`).

From the student's output on a fixed image panel: the keep / drop patch mask
(threshold mode's `keep_mask`, or the composed kept indices scattered onto
the N patches), drawn as the patch-drop grid with the first stage's scores
as an overlay and each image's correctness as its title; and the CLS
attention of every block, layer by head, with the pruned layers put back on
the original grid.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dense2sparse_vit_torch.ops.topk import compose_kept_indices, scatter_token_mask
from dense2sparse_vit_torch.viz.attention_segmentation import display_patch_drop, visualize_heads


def _host(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def epoch_visualize(images, student_output, num_patches: int, save_dir: str, epoch: int,
                    labels=None, patch_size: int = 16, visualize_patch_drop: bool = True,
                    visualize_cls_attn_evo: bool = False, pruning_locs=None) -> list:
    """Write `patch_drop_epoch_{epoch}.png` and (with visualize_cls_attn_evo
    and captured CLS rows) `cls_attn_evo_epoch_{epoch}.png` under save_dir.

    images: the (B, H, W, 3) normalised panel; student_output: the
    `StudentOutput` of the student on it (its tensors on any device);
    num_patches: the original spatial token count. Returns the paths
    written."""
    out = student_output
    written = []
    os.makedirs(save_dir, exist_ok=True)
    images = _host(images)

    if out.keep_mask is not None:
        keep_mask = _host(out.keep_mask)
    elif out.kept_idx:
        kept = compose_kept_indices([i.detach().cpu() for i in out.kept_idx])
        keep_mask = _host(scatter_token_mask(kept, num_patches))
    else:
        keep_mask = np.ones((images.shape[0], num_patches), np.float32)

    correct = None
    if labels is not None:
        correct = np.argmax(_host(out.logits), -1) == _host(labels)

    if visualize_patch_drop:
        scores = None
        if out.pred_logits:
            scores = torch.softmax(out.pred_logits[0].detach().float().cpu(), dim=-1).numpy()
        written.append(display_patch_drop(
            images, keep_mask, os.path.join(save_dir, f"patch_drop_epoch_{epoch}.png"),
            patch_scores=scores, correct=correct, patch_size=patch_size))
    if visualize_cls_attn_evo and out.cls_attns:
        written.append(visualize_heads(
            [_host(a) for a in out.cls_attns],
            os.path.join(save_dir, f"cls_attn_evo_epoch_{epoch}.png"),
            kept_idx_per_stage=[i.detach().cpu().numpy() for i in out.kept_idx],
            num_patches=num_patches, pruning_locs=pruning_locs))
    return written
