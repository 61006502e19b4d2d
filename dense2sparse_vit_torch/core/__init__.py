from dense2sparse_vit_torch.core.config import (
    ModelConfig,
    PruningConfig,
    deit_base,
    deit_small,
    deit_tiny,
)

__all__ = ["ModelConfig", "PruningConfig", "deit_base", "deit_small", "deit_tiny"]
