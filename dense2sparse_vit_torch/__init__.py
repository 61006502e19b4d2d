"""PyTorch + CUDA port of dense2sparse_vit_tpu for NVIDIA Hopper.

Imports torch and numpy only: never jax, nothing of the JAX package.
"""

from dense2sparse_vit_torch.core.config import ModelConfig, PruningConfig

__all__ = ["ModelConfig", "PruningConfig"]
