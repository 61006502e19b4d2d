"""Token selection and the hand-written CUDA kernels with their plain versions.

Each kernel wrapper counts its launches in a `launches` attribute; the
wrappers of this package are listed in `KERNELS`.
"""

from dense2sparse_vit_torch.ops.block import fused_transformer_block
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens, gather_tokens_reference
from dense2sparse_vit_torch.ops.predictor import fused_predictor_lg
from dense2sparse_vit_torch.ops.topk import topk_keep_indices

KERNELS = (fused_transformer_block, fused_predictor_lg, fused_gather_tokens)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "fused_gather_tokens", "fused_predictor_lg",
    "fused_transformer_block", "gather_tokens_reference", "launch_counts",
    "reset_launch_counts", "topk_keep_indices",
]
