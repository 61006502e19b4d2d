"""Token selection and the hand-written CUDA kernels with their plain versions.

Each kernel wrapper counts its launches in a `launches` attribute, where it
launches the kernel (for the serving path's kernels, in the `cuda`
implementation of their custom op, so that calls from an exported artifact
count too); the block's forward and backward count their policy-mode
launches apart, in `policy_launches`, and those with DropPath branch scales
in `scaled_launches`. The LayerNorm backward, the column sums and the
attention core's backward, which the backward entries launch from inside
their C code, are counted by the kernels' library where it launches them
(`ops.norm.LN_BWD`, `ops.norm.COLUMN_SUMS`, `ops.attention.ATTENTION_BWD`), and
so is the attention core at head widths other than 64, which they launch in
place of the width-64 cores (`ops.attention.ATTENTION_HD`, its forward, and
`ATTENTION_HD_BWD`, its backward).
`COUNTERS` lists every count by its name (the attention half-block's by
what they compute: its forward, its backward in plain and in policy mode,
and the variants' forward). Importing this package registers the custom ops
(`d2s::*`), which is all a loaded `torch.export` artifact needs of the port.
"""

from dense2sparse_vit_torch.ops.attention import (
    ATTENTION_BWD,
    ATTENTION_HD,
    ATTENTION_HD_BWD,
    fused_attention_backward_packed,
    fused_attention_block,
    fused_attention_block_backward,
    fused_attention_block_backward_policy,
    fused_attention_block_trainable,
    fused_attention_packed,
    fused_attention_packed_trainable,
    fused_attention_packed_with_cls_trainable,
    fused_attention_variant,
)
from dense2sparse_vit_torch.ops.block import (
    fused_transformer_block,
    fused_transformer_block_backward,
    fused_transformer_block_cls,
    fused_transformer_block_trainable,
)
from dense2sparse_vit_torch.ops.gather import (
    fused_gather_tokens,
    fused_scatter_tokens,
    gather_tokens_reference,
)
from dense2sparse_vit_torch.ops.mlp import fused_mlp_residual, fused_mlp_residual_backward
from dense2sparse_vit_torch.ops.norm import COLUMN_SUMS, LN_BWD
from dense2sparse_vit_torch.ops.predictor import fused_predictor_lg
from dense2sparse_vit_torch.ops.quant import fused_transformer_block_int8
from dense2sparse_vit_torch.ops.topk import mask_from_scores, threshold_keep_mask, topk_keep_indices

# (name, wrapper, attribute holding the count)
COUNTERS = (
    ("fused_transformer_block", fused_transformer_block, "launches"),
    ("fused_transformer_block[policy]", fused_transformer_block, "policy_launches"),
    ("fused_transformer_block_cls", fused_transformer_block_cls, "launches"),
    ("fused_transformer_block_backward", fused_transformer_block_backward, "launches"),
    ("fused_transformer_block_backward[policy]", fused_transformer_block_backward,
     "policy_launches"),
    ("fused_transformer_block[scaled]", fused_transformer_block, "scaled_launches"),
    ("fused_transformer_block_backward[scaled]", fused_transformer_block_backward,
     "scaled_launches"),
    ("fused_predictor_lg", fused_predictor_lg, "launches"),
    ("fused_gather_tokens", fused_gather_tokens, "launches"),
    ("fused_scatter_tokens", fused_scatter_tokens, "launches"),
    ("fused_transformer_block_int8", fused_transformer_block_int8, "launches"),
    ("fused_attention_packed", fused_attention_packed, "launches"),
    ("fused_attention_backward_packed", fused_attention_backward_packed, "launches"),
    ("fused_mlp_residual", fused_mlp_residual, "launches"),
    ("fused_mlp_residual_backward", fused_mlp_residual_backward, "launches"),
    ("attention_block_forward", fused_attention_block, "launches"),
    ("attention_block_backward", fused_attention_block_backward, "launches"),
    ("attention_block_backward_policy", fused_attention_block_backward_policy, "launches"),
    ("attention_variant", fused_attention_variant, "launches"),
    ("ln_bwd", LN_BWD, "launches"),
    ("column_sums", COLUMN_SUMS, "launches"),
    ("attention_bwd", ATTENTION_BWD, "launches"),
    ("attention_hd", ATTENTION_HD, "launches"),
    ("attention_hd_bwd", ATTENTION_HD_BWD, "launches"),
)
KERNEL_NAMES = tuple(name for name, _, _ in COUNTERS)
# the kernels that the backward entries launch from inside their C code
INNER_KERNELS = ("ln_bwd", "column_sums", "attention_bwd", "attention_hd", "attention_hd_bwd")


def reset_launch_counts() -> None:
    for _, fn, attr in COUNTERS:
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in COUNTERS}


def entry_launches() -> int:
    """Launches of the kernel entries so far, the kernels they launch inside
    (INNER_KERNELS) left out."""
    return sum(v for k, v in launch_counts().items() if k not in INNER_KERNELS)


__all__ = [
    "COUNTERS", "INNER_KERNELS", "KERNEL_NAMES", "entry_launches",
    "fused_attention_backward_packed", "fused_attention_block",
    "fused_attention_block_backward", "fused_attention_block_backward_policy",
    "fused_attention_block_trainable", "fused_attention_packed",
    "fused_attention_packed_trainable", "fused_attention_packed_with_cls_trainable",
    "fused_attention_variant", "fused_gather_tokens", "fused_mlp_residual",
    "fused_mlp_residual_backward",
    "fused_predictor_lg",
    "fused_scatter_tokens", "fused_transformer_block",
    "fused_transformer_block_backward", "fused_transformer_block_cls",
    "fused_transformer_block_int8", "fused_transformer_block_trainable", "gather_tokens_reference",
    "launch_counts", "mask_from_scores", "reset_launch_counts",
    "threshold_keep_mask", "topk_keep_indices",
]
