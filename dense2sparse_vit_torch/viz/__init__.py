"""Host-side pictures: attention segmentation, patch drop, head maps, and
the training loop's epoch-end hook."""

from dense2sparse_vit_torch.viz.attention_segmentation import (
    cls_attention_histogram,
    display_patch_drop,
    dynamic_keep_ratio_hist,
    generate_patch_mask,
    get_attention_masks,
    get_jaccard_similarity,
    head_maps,
    patch_drop_panel,
    save_image_grid,
    visualize_heads,
)
from dense2sparse_vit_torch.viz.hooks import epoch_visualize

__all__ = [
    "cls_attention_histogram", "display_patch_drop", "dynamic_keep_ratio_hist",
    "epoch_visualize", "generate_patch_mask", "get_attention_masks", "get_jaccard_similarity",
    "head_maps", "patch_drop_panel", "save_image_grid", "visualize_heads",
]
