"""Model registry (port of the student and teacher part of
`dense2sparse_vit_tpu/models/registry.py`)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from dense2sparse_vit_torch.core.config import (
    ModelConfig,
    PruningConfig,
    deit_base,
    deit_small,
    deit_tiny,
)
from dense2sparse_vit_torch.models.student import DiffPruningStudent
from dense2sparse_vit_torch.models.teacher import ViTTeacher

_REGISTRY: Dict[str, Callable] = {}

# The headline student, as the JAX package's bench.py builds it: DeiT-S/16 at
# 224 px in bf16, pruned at blocks 3/6/9 to 0.7/0.49/0.343 of the patches,
# with the small predictor: create_model(HEADLINE_MODEL, **HEADLINE_KWARGS).
HEADLINE_MODEL = "dynamic_vit_small_patch16_224_student"
# and the teacher the train step distils it from (the same widths, dense)
HEADLINE_TEACHER = "dynamic_vit_small_patch16_224_teacher"
HEADLINE_KWARGS = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343),
                       dtype="bfloat16", small_predictor=True)


def list_models():
    return sorted(_REGISTRY)


def create_model(
    name: str,
    *,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
    **kwargs,
):
    """Instantiate a registered model by name, with initialised weights.

    Keyword arguments are those of the JAX package's `create_model`
    (`pruning_locs`, `keep_ratios`, any `ModelConfig` or `PruningConfig`
    field). The weights are drawn on the CPU from `generator` (seed 0 when
    None) and the model is then moved to `device`: the card unless the
    caller asks for the CPU with device="cpu".
    """
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {list_models()}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"create_model builds on {device} and there is no CUDA device: "
            "pass device='cpu' to build on the CPU"
        )
    model = _REGISTRY[name](**kwargs)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return model.init_weights(generator).to(device)


def _student(size_cfg: ModelConfig):
    def factory(
        pruning_locs: Sequence[int] = (3,),
        keep_ratios: Sequence[float] = (0.7,),
        **kwargs,
    ):
        pruning_kwargs = {
            k: kwargs.pop(k)
            for k in list(kwargs)
            if k in PruningConfig.__dataclass_fields__
        }
        return DiffPruningStudent(
            cfg=size_cfg.replace(**kwargs),
            pruning=PruningConfig(
                pruning_locs=tuple(pruning_locs),
                keep_ratios=tuple(keep_ratios),
                **pruning_kwargs,
            ),
        )

    return factory


def _teacher(size_cfg: ModelConfig):
    def factory(**kwargs):
        return ViTTeacher(cfg=size_cfg.replace(**kwargs))

    return factory


_REGISTRY["dynamic_vit_tiny_patch16_224_student"] = _student(deit_tiny())
_REGISTRY["dynamic_vit_small_patch16_224_student"] = _student(deit_small())
_REGISTRY["dynamic_vit_base_patch16_224_student"] = _student(deit_base())
_REGISTRY["dynamic_vit_tiny_patch16_224_teacher"] = _teacher(deit_tiny())
_REGISTRY["dynamic_vit_small_patch16_224_teacher"] = _teacher(deit_small())
_REGISTRY["dynamic_vit_base_patch16_224_teacher"] = _teacher(deit_base())
