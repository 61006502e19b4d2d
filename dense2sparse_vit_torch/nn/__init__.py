from dense2sparse_vit_torch.nn.layers import (
    Attention,
    Block,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    draw_branch_scales,
    dropout,
    dropout_keep_mask,
)
from dense2sparse_vit_torch.nn.predictor import BatchNormLayer, PredictorLG
from dense2sparse_vit_torch.nn.t2t import T2TModule, TokenPerformer, TokenTransformer

__all__ = [
    "Attention", "BatchNormLayer", "Block", "DropPath", "LayerNorm", "Linear", "Mlp",
    "PatchEmbed", "PredictorLG", "T2TModule", "TokenPerformer", "TokenTransformer",
    "draw_branch_scales", "dropout", "dropout_keep_mask",
]
