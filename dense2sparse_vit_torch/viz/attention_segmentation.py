"""Attention segmentation and patch-drop pictures (port of
`dense2sparse_vit_tpu/viz/attention_segmentation.py`).

Host-side numpy, rank 0 only. Every renderer is split in two: a numeric
part, a copy of the JAX module's arithmetic that a test can hold against it
(`denormalize`, `get_attention_masks`, `generate_patch_mask`,
`get_jaccard_similarity`, `patch_drop_panel`, `head_maps`,
`dynamic_keep_ratio_hist`'s and `cls_attention_histogram`'s counts), and a
write, which draws the numbers into a PNG with Pillow: image grids with
`ImageDraw` titles, heat maps through a viridis table. The JAX module draws
with matplotlib, which the port does not need; so `dynamic_keep_ratio_hist`
returns the histogram's counts where the JAX one returns its figure. Inputs
are numpy arrays or host tensors; images are NHWC, normalised (undone with
the ImageNet mean and std) or in [0, 1].
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# matplotlib's viridis at 17 evenly spaced points, 0-255 RGB; `colorize`
# interpolates between them (within 6 / 255 of the 256-entry table)
VIRIDIS = np.array([
    [68, 1, 84], [72, 24, 106], [71, 45, 123], [66, 64, 134], [59, 82, 139],
    [51, 99, 141], [44, 114, 142], [38, 130, 142], [33, 145, 140], [31, 160, 136],
    [40, 174, 128], [63, 188, 115], [94, 201, 98], [132, 212, 75], [173, 220, 48],
    [216, 226, 25], [253, 231, 37],
], np.float32)

TILE = 224  # the side of one grid tile, pixels
TITLE = 14  # the height of a title line, pixels


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def denormalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Undo the ImageNet normalisation to [0, 1] for display."""
    return np.clip(_np(images) * std + mean, 0.0, 1.0)


def get_attention_masks(attn, threshold: float = 0.6, grid: Optional[int] = None,
                        patch_size: int = 16) -> np.ndarray:
    """(B, N) head-aggregated CLS attention -> (B, H, W) boolean pixel mask
    of the patches that hold the top `threshold` of the attention mass
    (the ascending cumulative share above 1 - threshold), each patch
    upsampled to patch_size pixels."""
    attn = _np(attn)
    B, N = attn.shape
    g = grid or int(round(np.sqrt(N)))
    order = np.argsort(attn, axis=-1)  # ascending
    sorted_vals = np.take_along_axis(attn, order, axis=-1)
    cum = np.cumsum(sorted_vals / sorted_vals.sum(-1, keepdims=True), axis=-1)
    keep_sorted = cum > (1.0 - threshold)
    mask = np.zeros((B, N), bool)
    np.put_along_axis(mask, order, keep_sorted, axis=-1)
    mask = mask.reshape(B, g, g)
    return np.kron(mask, np.ones((patch_size, patch_size), bool))


def generate_patch_mask(keep_mask, patch_size: int = 16) -> np.ndarray:
    """(B, N) patch keep mask -> (B, H, W, 1) pixel mask."""
    keep_mask = _np(keep_mask)
    B, N = keep_mask.shape
    g = int(round(np.sqrt(N)))
    grid = keep_mask.reshape(B, g, g)
    return np.kron(grid, np.ones((patch_size, patch_size)))[..., None]


def get_jaccard_similarity(keep_mask, attention_mask) -> np.ndarray:
    """(B,) intersection over union of two (B, N) binary masks."""
    a = _np(keep_mask).astype(bool)
    b = _np(attention_mask).astype(bool)
    inter = (a & b).sum(-1)
    union = (a | b).sum(-1)
    return inter / np.maximum(union, 1)


def dynamic_keep_ratio_hist(keep_ratios, title: str = "",
                            save_path: Optional[str] = None) -> np.ndarray:
    """The (20,) counts of the per-image keep ratios over 20 bins of [0, 1]
    (threshold mode's histogram), drawn as bars into save_path if given."""
    counts, _ = np.histogram(_np(keep_ratios).ravel(), bins=20, range=(0, 1))
    if save_path:
        _save(_bars([counts], [title or "dynamic keep ratios"]), save_path)
    return counts


def image_grid(images, ncols: int = 4) -> np.ndarray:
    """(n, H, W, 3) images in [0, 1] -> (rows, ncols, H, W, 3), the empty
    cells zero."""
    images = np.clip(_np(images), 0, 1)
    n = len(images)
    nrows = -(-n // ncols)
    cells = np.zeros((nrows * ncols,) + images.shape[1:], images.dtype)
    cells[:n] = images
    return cells.reshape((nrows, ncols) + images.shape[1:])


def save_image_grid(images, save_path: str, titles: Optional[Sequence[str]] = None,
                    ncols: int = 4, suptitle: str = "") -> str:
    """Write the images as a grid of ncols columns, a title over each where
    `titles` has one and `suptitle` over the grid; returns save_path."""
    cells = image_grid(images, ncols)
    nrows = cells.shape[0]
    tiles = [[_tile(cells[r, c]) for c in range(ncols)] for r in range(nrows)]
    names = [[str(titles[r * ncols + c]) if titles is not None and r * ncols + c < len(titles)
              else "" for c in range(ncols)] for r in range(nrows)]
    _save(_compose(tiles, names, suptitle), save_path)
    return save_path


def patch_drop_panel(images, keep_mask, patch_scores=None, patch_size: int = 16,
                     denorm: bool = True) -> np.ndarray:
    """The (B, H, W, 3) masked images `display_patch_drop` draws: the
    dropped patches black, or with `patch_scores` ((B, N) predictor scores)
    a red overlay of 0.6 times the scores normalised by each image's
    largest."""
    imgs = denormalize(images) if denorm else np.clip(_np(images), 0, 1)
    pix_mask = generate_patch_mask(keep_mask, patch_size)
    masked = imgs * pix_mask
    if patch_scores is not None:
        scores = _np(patch_scores)
        heat = generate_patch_mask(scores / (scores.max(-1, keepdims=True) + 1e-8), patch_size)
        overlay = np.zeros_like(masked)
        overlay[..., 0] = heat[..., 0]
        masked = np.where(pix_mask > 0, masked, 0.6 * overlay)
    return masked


def display_patch_drop(images, keep_mask, save_path: str, patch_scores=None, correct=None,
                       patch_size: int = 16, denorm: bool = True) -> str:
    """Masked-image grid (`patch_drop_panel`) with "correct" / "wrong"
    titles where `correct` ((B,) bool) is given; returns save_path."""
    masked = patch_drop_panel(images, keep_mask, patch_scores, patch_size, denorm)
    titles = None
    if correct is not None:
        titles = ["correct" if c else "wrong" for c in _np(correct)]
    return save_image_grid(masked, save_path, titles=titles,
                           suptitle=f"kept {float(_np(keep_mask).mean()):.0%} of patches")


def head_maps(cls_attns: Sequence, kept_idx_per_stage: Optional[Sequence] = None,
              image_index: int = 0, num_patches: Optional[int] = None,
              pruning_locs: Optional[Sequence[int]] = None) -> list:
    """Per layer, the (H, N) CLS-attention rows of image `image_index` on
    the original N-token grid: a pruned layer's rows are scattered to the
    positions its tokens came from (zeros elsewhere), through the
    stage-local kept-index chain. With `pruning_locs` (one cls_attns entry
    per layer) a layer composes exactly the stages at or before it; without,
    the first prefix of the chain whose width matches. Raises ValueError
    where no prefix maps a layer's width."""
    cls_attns = [_np(a) for a in cls_attns]  # each (B, H, N_layer)
    N = num_patches or cls_attns[0].shape[-1]

    def compose(chain):
        idx = None
        for stage in chain:
            stage = _np(stage)[image_index]
            idx = stage if idx is None else idx[stage]
        return idx

    full_rows = []
    for li, a in enumerate(cls_attns):
        row = a[image_index]  # (H, N_layer)
        n_layer = row.shape[-1]
        if n_layer != N and kept_idx_per_stage is not None:
            if pruning_locs is not None:
                # the gather at a pruning layer runs before its block
                n_stages = sum(1 for loc in pruning_locs if loc <= li)
                idx = compose(kept_idx_per_stage[:n_stages])
            else:
                idx = None
                for k in range(1, len(kept_idx_per_stage) + 1):
                    cand = compose(kept_idx_per_stage[:k])
                    if len(cand) == n_layer:
                        idx = cand
                        break
            if idx is None or len(idx) != n_layer:
                raise ValueError(
                    f"cannot map layer {li} width {n_layer} onto the original {N} tokens "
                    f"from the kept-index chain {[_np(s).shape[-1] for s in kept_idx_per_stage]}; "
                    "pass pruning_locs for exact composition")
            padded = np.zeros((row.shape[0], N), row.dtype)
            padded[:, idx] = row
            row = padded
        full_rows.append(row)
    return full_rows


def visualize_heads(cls_attns: Sequence, save_path: str,
                    kept_idx_per_stage: Optional[Sequence] = None, image_index: int = 0,
                    num_patches: Optional[int] = None,
                    pruning_locs: Optional[Sequence[int]] = None) -> str:
    """A layer x head grid of `head_maps`, each map on its g x g grid in
    viridis (scaled to its own range); returns save_path."""
    rows = head_maps(cls_attns, kept_idx_per_stage, image_index, num_patches, pruning_locs)
    N = rows[0].shape[-1]
    g = int(round(np.sqrt(N)))
    tiles = [[_tile(colorize(m.reshape(g, g)), side=96) for m in r] for r in rows]
    names = [[f"head {h}" if li == 0 else "" for h in range(len(r))]
             for li, r in enumerate(rows)]
    _save(_compose(tiles, names, ""), save_path)
    return save_path


def cls_attention_histogram(cls_attns, save_path: str, bins: int = 30) -> str:
    """Per-layer histograms of the (B, L, H, N) CLS attention weights, one
    panel a layer (`attention_histogram_counts`); returns save_path."""
    counts = attention_histogram_counts(cls_attns, bins)
    _save(_bars(counts, [f"layer {li}" for li in range(len(counts))]), save_path)
    return save_path


def attention_histogram_counts(cls_attns, bins: int = 30) -> list:
    """Per layer, the `bins` counts of np.histogram over (B, L, H, N)'s
    layer's weights, as matplotlib's `hist` bins them."""
    a = _np(cls_attns)
    return [np.histogram(a[:, li].ravel(), bins=bins)[0] for li in range(a.shape[1])]


# ---- the writes -------------------------------------------------------------


def colorize(values) -> np.ndarray:
    """A 2-D map -> (h, w, 3) RGB in [0, 1] through viridis, scaled from its
    minimum to its maximum (a constant map takes the lowest colour)."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    pos = t * (len(VIRIDIS) - 1)
    i = np.clip(np.floor(pos).astype(int), 0, len(VIRIDIS) - 2)
    f = (pos - i)[..., None]
    return (VIRIDIS[i] * (1 - f) + VIRIDIS[i + 1] * f) / 255.0


def _tile(img, side: int = TILE):
    from PIL import Image

    arr = (np.clip(np.asarray(img, np.float64), 0, 1) * 255).round().astype(np.uint8)
    return Image.fromarray(arr).resize((side, side), Image.NEAREST)


def _compose(tiles, names, suptitle: str):
    """Paste the rows of PIL tiles into one white picture, each tile under
    its title line, and the suptitle on top."""
    from PIL import Image, ImageDraw

    pad = 4
    tw, th = tiles[0][0].size
    ncols = max(len(r) for r in tiles)
    top = TITLE + pad if suptitle else 0
    cell_h = th + TITLE + pad
    canvas = Image.new("RGB", (ncols * (tw + pad) + pad, top + len(tiles) * cell_h + pad),
                       "white")
    draw = ImageDraw.Draw(canvas)
    if suptitle:
        draw.text((pad, pad // 2), suptitle, fill="black")
    for r, row in enumerate(tiles):
        for c, tile in enumerate(row):
            x, y = pad + c * (tw + pad), top + r * cell_h
            if names[r][c]:
                draw.text((x, y), names[r][c], fill="black")
            canvas.paste(tile, (x, y + TITLE))
    return canvas


def _bars(counts, names, width: int = 200, height: int = 120):
    """One bar-chart tile of each counts vector, side by side."""
    from PIL import Image, ImageDraw

    tiles = []
    for c in counts:
        c = np.asarray(c, np.float64)
        im = Image.new("RGB", (width, height), "white")
        d = ImageDraw.Draw(im)
        top = max(float(c.max()), 1.0)
        bw = width / max(len(c), 1)
        for i, v in enumerate(c):
            h = int(round((height - 2) * v / top))
            d.rectangle([int(i * bw), height - 1 - h, int((i + 1) * bw) - 1, height - 1],
                        fill=(31, 119, 180))
        tiles.append(im)
    return _compose([tiles], [list(names)], "")


def _save(image, save_path: str) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    image.save(save_path)
