"""Model registry (port of `dense2sparse_vit_tpu/models/registry.py`): the
students and teachers, the DeiT, ViT and DINO backbones, the hierarchical
and ensemble DeiT, the T2T-ViT family with its SE, Ghost and Dense
variants, TNT, the Drop-ResNet-50 and the aliases of the reference's
factory names: every name and alias of the JAX registry. Two of them reach
the block kernels at a head width other than 64 with
`use_fused_attention=True`: `vit_small_patch16_224` (the timm v0.1 ViT-S,
8 heads of 96) and `t2t_vit_14_resnext` (32 heads of 12)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from dense2sparse_vit_torch.core.config import (
    ModelConfig,
    PruningConfig,
    deit_base,
    deit_small,
    deit_tiny,
)
from dense2sparse_vit_torch.models.dynamic_vit_default import DynamicViTStudent
from dense2sparse_vit_torch.models.student import DiffPruningStudent
from dense2sparse_vit_torch.models.t2t import T2TViT
from dense2sparse_vit_torch.models.teacher import ViTTeacher
from dense2sparse_vit_torch.nn.t2t import T2TModule

_REGISTRY: Dict[str, Callable] = {}
_ALIASES: Dict[str, str] = {}

# The headline student, as the JAX package's bench.py builds it: DeiT-S/16 at
# 224 px in bf16, pruned at blocks 3/6/9 to 0.7/0.49/0.343 of the patches,
# with the small predictor: create_model(HEADLINE_MODEL, **HEADLINE_KWARGS).
HEADLINE_MODEL = "dynamic_vit_small_patch16_224_student"
# and the teacher the train step distils it from (the same widths, dense)
HEADLINE_TEACHER = "dynamic_vit_small_patch16_224_teacher"
HEADLINE_KWARGS = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343),
                       dtype="bfloat16", small_predictor=True)
# threshold mode: the same student keeping, at each stage, each image's
# tokens above half of the predictor's score mass (bench_train.py's
# threshold row)
THRESHOLD_KWARGS = dict(HEADLINE_KWARGS, patch_score_threshold=0.5)
# attn selection (the JAX package's --attn-selection): the same student
# ranking each stage's tokens by the previous block's CLS-attention row, with
# no predictors
ATTN_KWARGS = dict(HEADLINE_KWARGS, selection="attn")
# the gumbel baseline at the same widths, stages and keep ratios
GUMBEL_MODEL = "default_dynamic_vit_small_patch16_224_student"
GUMBEL_KWARGS = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343),
                     dtype="bfloat16")
# the pruned T2T-ViT-14 (performer stem, sinusoid positions, 6 heads of 64,
# mlp_ratio 3, no qkv bias, LayerNorm eps 1e-5), as the JAX package's
# bench_zoo.py builds its config 4: create_model(T2T_MODEL, **T2T_KWARGS)
T2T_MODEL = "t2t_vit_14_student"
T2T_KWARGS = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343),
                  dtype="bfloat16", use_fused_attention=True)
# the pruned DINO ViT-S/16 student with perturbed (soft) top-k in training,
# the JAX package's bench_zoo.py config 5: create_model(DINO_MODEL,
# **DINO_KWARGS)
DINO_MODEL = "dino_small_student"
DINO_KWARGS = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343),
                   dtype="bfloat16", use_fused_attention=True)


def list_models():
    return sorted(_REGISTRY)


def register_alias(alias: str, target: str) -> None:
    """Let `create_model` build `target` under the name `alias` too."""
    _ALIASES[alias] = target


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
    caller asks for the CPU with device="cpu". Aliases (`register_alias`)
    are accepted.
    """
    name = _ALIASES.get(name, name)
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


def _student(size_cfg: ModelConfig, cls=DiffPruningStudent, **pruning_defaults):
    """A student factory: keyword arguments that are PruningConfig fields go
    to its PruningConfig (over `pruning_defaults`), the rest to the
    ModelConfig."""
    def factory(**kwargs):
        pruning = dict(pruning_defaults)
        pruning.update({k: kwargs.pop(k) for k in list(kwargs)
                        if k in PruningConfig.__dataclass_fields__})
        for k in ("pruning_locs", "keep_ratios"):
            if k in pruning:
                pruning[k] = tuple(pruning[k])
        return cls(cfg=size_cfg.replace(**kwargs), pruning=PruningConfig(**pruning))

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
# the DynamicViT-paper baseline (stages at 3/6/9 keeping 0.7/0.49/0.343
# unless told otherwise) and its teachers, the same plain ViT
_GUMBEL = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343), selection="gumbel")
for _size, _cfg in (("tiny", deit_tiny()), ("small", deit_small()), ("base", deit_base())):
    _REGISTRY[f"default_dynamic_vit_{_size}_patch16_224_student"] = _student(
        _cfg, DynamicViTStudent, **_GUMBEL)
    _REGISTRY[f"default_dynamic_vit_{_size}_patch16_224_teacher"] = _teacher(_cfg)


def _t2t_config(embed_dim, depth, num_heads, mlp_ratio, **kwargs) -> ModelConfig:
    return ModelConfig(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                       mlp_ratio=mlp_ratio, qkv_bias=False, layer_norm_eps=1e-5, **kwargs)


def _t2t(embed_dim, depth, num_heads, mlp_ratio, tokens_type="performer"):
    """A dense T2T-ViT factory (JAX `registry.py:230-247`); `tokens_type`
    and `token_dim` may be given, the rest goes to the ModelConfig."""
    def factory(**kwargs):
        stem = {"tokens_type": kwargs.pop("tokens_type", tokens_type)}
        if "token_dim" in kwargs:
            stem["token_dim"] = kwargs.pop("token_dim")
        return T2TViT(_t2t_config(embed_dim, depth, num_heads, mlp_ratio, **kwargs), **stem)

    return factory


def _t2t_student(embed_dim, depth, num_heads, mlp_ratio, tokens_type="performer"):
    """A pruned T2T-ViT factory (JAX `registry.py:397-431`): the student on
    a T2T stem with the fixed sinusoid table, stages at 3/6/9 keeping
    0.7/0.49/0.343 unless told otherwise."""
    def factory(**kwargs):
        pruning = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343))
        pruning.update({k: kwargs.pop(k) for k in list(kwargs)
                        if k in PruningConfig.__dataclass_fields__})
        for k in ("pruning_locs", "keep_ratios"):
            pruning[k] = tuple(pruning[k])
        cfg = _t2t_config(embed_dim, depth, num_heads, mlp_ratio, **kwargs)
        return DiffPruningStudent(cfg, PruningConfig(**pruning),
                                  stem=T2TModule(embed_dim, tokens_type, in_chans=cfg.in_chans),
                                  pos_embed_type="sinusoid")

    return factory


# the T2T-ViT family (JAX `registry.py:250-271`); resnext's heads are 12
# wide, the others' 64
for _name, _shape in (("7", (256, 7, 4, 2.0)), ("10", (256, 10, 4, 2.0)),
                      ("12", (256, 12, 4, 2.0)), ("14", (384, 14, 6, 3.0)),
                      ("19", (448, 19, 7, 3.0)), ("24", (512, 24, 8, 3.0)),
                      ("14_resnext", (384, 14, 32, 3.0)), ("14_wide", (768, 4, 12, 3.0))):
    _REGISTRY[f"t2t_vit_{_name}"] = _t2t(*_shape)
for _name, _shape in (("14", (384, 14, 6, 3.0)), ("19", (448, 19, 7, 3.0)),
                      ("24", (512, 24, 8, 3.0))):
    _REGISTRY[f"t2t_vit_t_{_name}"] = _t2t(*_shape, tokens_type="transformer")


def _t2t_variant(cls_name, embed_dim, depth, num_heads, mlp_ratio):
    """A T2T variant's factory (JAX `_t2t` with the SE, Ghost and Dense
    classes): keyword arguments that are the class's own fields (its
    FIELDS) go to the class, the rest to the ModelConfig."""
    def factory(**kwargs):
        from dense2sparse_vit_torch.models import t2t

        cls = getattr(t2t, cls_name)
        fields = {k: kwargs.pop(k) for k in list(kwargs) if k in cls.FIELDS}
        return cls(_t2t_config(embed_dim, depth, num_heads, mlp_ratio, **kwargs), **fields)

    return factory


_REGISTRY["t2t_vit_14_se"] = _t2t_variant("T2TViTSE", 384, 14, 6, 3.0)
_REGISTRY["t2t_vit_16_ghost"] = _t2t_variant("T2TViTGhost", 384, 16, 6, 3.0)
_REGISTRY["t2t_vit_dense"] = _t2t_variant("T2TViTDense", 128, 12, 4, 2.0)


def _tnt(embed_dim, depth, num_heads, in_dim, in_num_head):
    """A TNT factory (JAX `registry.py:274-289`)."""
    def factory(**kwargs):
        from dense2sparse_vit_torch.models.tnt import TNT

        fields = {k: kwargs.pop(k) for k in list(kwargs) if k in TNT.FIELDS}
        cfg = ModelConfig(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                          qkv_bias=False, layer_norm_eps=1e-5, **kwargs)
        return TNT(cfg, **{"in_dim": in_dim, "in_num_head": in_num_head, **fields})

    return factory


_REGISTRY["tnt_s_patch16_224"] = _tnt(384, 12, 6, 24, 4)
_REGISTRY["tnt_b_patch16_224"] = _tnt(640, 12, 10, 40, 4)


def _drop_resnet(**kwargs):
    from dense2sparse_vit_torch.models.resnet import drop_resnet50

    return drop_resnet50(**kwargs)


_REGISTRY["drop_resnet50"] = _drop_resnet
_REGISTRY["t2t_vit_14_student"] = _t2t_student(384, 14, 6, 3.0)
_REGISTRY["t2t_vit_t_14_student"] = _t2t_student(384, 14, 6, 3.0, tokens_type="transformer")


# the pruned DINO students (JAX `registry.py:441-468`): DeiT-shape students,
# stages at 3/6/9 keeping 0.7/0.49/0.343 unless told otherwise, with
# perturbed top-k (differentiable_topk) on unless told otherwise
_DINO = dict(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343), differentiable_topk=True)
_REGISTRY["dino_small_student"] = _student(deit_small(), **_DINO)
_REGISTRY["dino_tiny_student"] = _student(deit_tiny(), **_DINO)


def _family(module: str, cls_name: str, size_cfg: ModelConfig, dino: bool = False):
    """A backbone factory (JAX `_deit`, `_dino`, `_heads`): keyword arguments
    that are the class's own fields (its FIELDS: the JAX dataclass fields)
    go to the class, the rest to the ModelConfig; a DINO factory also takes
    `patch_size` (default 16)."""
    def factory(**kwargs):
        import importlib

        cls = getattr(importlib.import_module(f"dense2sparse_vit_torch.models.{module}"),
                      cls_name)
        fields = {k: kwargs.pop(k) for k in list(kwargs) if k in cls.FIELDS}
        if dino:
            kwargs.setdefault("patch_size", 16)
        return cls(size_cfg.replace(**kwargs), **fields)

    return factory


# the DeiT family (JAX `registry.py:158-191`)
for _size, _cfg in (("tiny", deit_tiny()), ("small", deit_small()), ("base", deit_base())):
    _REGISTRY[f"deit_{_size}_patch16_224"] = _family("deit", "DeiT", _cfg)
    _REGISTRY[f"deit_{_size}_distilled_patch16_224"] = _family("deit", "DistilledDeiT", _cfg)
    _REGISTRY[f"vanilla_deit_{_size}_patch16_224"] = _family("deit", "VanillaDeiT", _cfg)
_REGISTRY["deit_base_patch16_384"] = _family("deit", "DeiT", deit_base(img_size=384))
_REGISTRY["nonspatial_deit_small_patch16_224"] = _family("deit", "NonSpatialDeiT", deit_small())
_REGISTRY["deit_small_patch16_224_masked"] = _family("deit", "MaskedDistilledDeiT",
                                                     deit_small())
_REGISTRY["deit_small_patch16_224_predictor"] = _family("deit", "MaskPredictorDeiT",
                                                        deit_small())

# the DINO family (JAX `registry.py:212-227`); its checkpoints are headless
for _name, _cls, _cfg in (
        ("dino_tiny", "DINOViT", deit_tiny(num_classes=0)),
        ("dino_small", "DINOViT", deit_small(num_classes=0)),
        ("dino_base", "DINOViT", deit_base(num_classes=0)),
        ("dino_small_predictor", "DINOPredictorViT", deit_small(num_classes=0)),
        ("dino_small_dist", "DINODistilledViT", deit_small(num_classes=0)),
        ("dino_tiny_dist", "DINODistilledViT", deit_tiny(num_classes=0)),
        ("dino_small_patch16_224_masked", "DINOMaskedViT", deit_small())):
    _REGISTRY[_name] = _family("dino", _cls, _cfg, dino=True)

# hierarchical and ensemble DeiT (JAX `registry.py:307-333`)
for _size, _cfg in (("tiny", deit_tiny()), ("small", deit_small()), ("base", deit_base())):
    _REGISTRY[f"{_size}_patch16_224_hierarchical"] = _family("deit_heads", "HierarchicalDeiT",
                                                             _cfg)
for _size, _cfg in (("tiny", deit_tiny()), ("small", deit_small())):
    _REGISTRY[f"{_size}_patch16_224_ensemble"] = _family("deit_heads", "EnsembleDeiT", _cfg)

# the timm-style ViTs with per-layer logits (JAX `registry.py:336-375`);
# the timm v0.1 vit_small is 768 wide, depth 8, 8 heads of 96, MLP ratio 3
_VIT_B = dict(embed_dim=768, depth=12, num_heads=12)
_VIT_L = dict(embed_dim=1024, depth=24, num_heads=16)
for _name, _cfg in (
        ("vit_small_patch16_224", ModelConfig(embed_dim=768, depth=8, num_heads=8,
                                              mlp_ratio=3.0)),
        ("vit_base_patch16_224", ModelConfig(**_VIT_B)),
        ("vit_base_patch16_384", ModelConfig(**_VIT_B, img_size=384)),
        ("vit_base_patch32_384", ModelConfig(**_VIT_B, img_size=384, patch_size=32)),
        ("vit_large_patch16_224", ModelConfig(**_VIT_L)),
        ("vit_large_patch16_384", ModelConfig(**_VIT_L, img_size=384)),
        ("vit_large_patch32_384", ModelConfig(**_VIT_L, img_size=384, patch_size=32))):
    _REGISTRY[_name] = _family("deit", "VanillaDeiT", _cfg)

# the reference's factory names (JAX `registry.py:380-394`)
for _n in ("7", "10", "12", "14", "19", "24", "14_resnext", "14_wide"):
    register_alias(f"T2t_vit_{_n}", f"t2t_vit_{_n}")
register_alias("T2t_vit_16_ghost", "t2t_vit_16_ghost")
for _n in ("14", "19", "24"):
    register_alias(f"T2t_vit_t_{_n}", f"t2t_vit_t_{_n}")
for _size in ("tiny", "small", "base"):
    register_alias(f"vit_deit_{_size}_patch16_224", f"deit_{_size}_patch16_224")
register_alias("vit_deit_small_distilled_patch16_224", "deit_small_distilled_patch16_224")
register_alias("deit_small_dist_masked", "deit_small_patch16_224_masked")
register_alias("deit_small_dist_predictor", "deit_small_patch16_224_predictor")
