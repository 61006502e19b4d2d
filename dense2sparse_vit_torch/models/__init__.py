from dense2sparse_vit_torch.models.registry import (
    HEADLINE_KWARGS,
    HEADLINE_MODEL,
    create_model,
    list_models,
)
from dense2sparse_vit_torch.models.student import DiffPruningStudent, StudentOutput

__all__ = [
    "DiffPruningStudent", "HEADLINE_KWARGS", "HEADLINE_MODEL", "StudentOutput",
    "create_model", "list_models",
]
