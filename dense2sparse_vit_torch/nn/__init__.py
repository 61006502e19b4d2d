from dense2sparse_vit_torch.nn.layers import (
    Attention,
    Block,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
)
from dense2sparse_vit_torch.nn.predictor import PredictorLG

__all__ = [
    "Attention", "Block", "DropPath", "LayerNorm", "Linear", "Mlp",
    "PatchEmbed", "PredictorLG",
]
