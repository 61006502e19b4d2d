from dense2sparse_vit_torch.models.registry import (
    HEADLINE_KWARGS,
    HEADLINE_MODEL,
    HEADLINE_TEACHER,
    create_model,
    list_models,
)
from dense2sparse_vit_torch.models.student import DiffPruningStudent, StudentOutput
from dense2sparse_vit_torch.models.teacher import ViTTeacher

__all__ = [
    "DiffPruningStudent", "HEADLINE_KWARGS", "HEADLINE_MODEL", "HEADLINE_TEACHER",
    "StudentOutput",
    "ViTTeacher", "create_model", "list_models",
]
