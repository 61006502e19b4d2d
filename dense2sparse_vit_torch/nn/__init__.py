from dense2sparse_vit_torch.nn.layers import (
    Attention,
    Block,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    draw_branch_scales,
)
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.nn.t2t import T2TModule, TokenPerformer, TokenTransformer

__all__ = [
    "Attention", "Block", "DropPath", "LayerNorm", "Linear", "Mlp",
    "PatchEmbed", "PredictorLG", "T2TModule", "TokenPerformer", "TokenTransformer",
    "draw_branch_scales",
]
