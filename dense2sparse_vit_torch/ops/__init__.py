"""Token selection and the hand-written CUDA kernels with their plain versions.

Each kernel wrapper counts its launches in a `launches` attribute; the
wrappers of this package are listed in `KERNELS`.
"""

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
from dense2sparse_vit_torch.ops.predictor import fused_predictor_lg
from dense2sparse_vit_torch.ops.topk import mask_from_scores, topk_keep_indices

KERNELS = (
    fused_transformer_block, fused_transformer_block_cls,
    fused_transformer_block_backward, fused_predictor_lg, fused_gather_tokens,
    fused_scatter_tokens,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "fused_gather_tokens", "fused_predictor_lg",
    "fused_scatter_tokens", "fused_transformer_block",
    "fused_transformer_block_backward", "fused_transformer_block_cls",
    "fused_transformer_block_trainable", "gather_tokens_reference",
    "launch_counts", "mask_from_scores", "reset_launch_counts",
    "topk_keep_indices",
]
