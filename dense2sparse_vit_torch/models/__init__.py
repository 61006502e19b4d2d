from dense2sparse_vit_torch.models.registry import (
    ATTN_KWARGS,
    DINO_KWARGS,
    DINO_MODEL,
    GUMBEL_KWARGS,
    GUMBEL_MODEL,
    HEADLINE_KWARGS,
    HEADLINE_MODEL,
    HEADLINE_TEACHER,
    T2T_KWARGS,
    T2T_MODEL,
    THRESHOLD_KWARGS,
    create_model,
    list_models,
)
from dense2sparse_vit_torch.models.dynamic_vit_default import (
    DynamicViTOutput,
    DynamicViTPredictor,
    DynamicViTStudent,
)
from dense2sparse_vit_torch.models.student import DiffPruningStudent, StudentOutput
from dense2sparse_vit_torch.models.t2t import T2TViT
from dense2sparse_vit_torch.models.teacher import ViTTeacher

__all__ = [
    "ATTN_KWARGS", "DINO_KWARGS", "DINO_MODEL", "DiffPruningStudent", "DynamicViTOutput", "DynamicViTPredictor", "DynamicViTStudent",
    "GUMBEL_KWARGS", "GUMBEL_MODEL", "HEADLINE_KWARGS", "HEADLINE_MODEL", "HEADLINE_TEACHER",
    "StudentOutput", "T2TViT", "T2T_KWARGS", "T2T_MODEL", "THRESHOLD_KWARGS",
    "ViTTeacher", "create_model", "list_models",
]
