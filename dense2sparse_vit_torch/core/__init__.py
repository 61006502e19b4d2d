from dense2sparse_vit_torch.core.config import (
    ExperimentConfig,
    ModelConfig,
    PruningConfig,
    TrainConfig,
    deit_base,
    deit_small,
    deit_tiny,
)

__all__ = [
    "ExperimentConfig", "ModelConfig", "PruningConfig", "TrainConfig",
    "deit_base", "deit_small", "deit_tiny",
]
