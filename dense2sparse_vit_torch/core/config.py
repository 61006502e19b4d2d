"""The typed configuration: model, pruning, training, data and experiment.

A copy of `dense2sparse_vit_tpu/core/config.py::ModelConfig`,
`::PruningConfig`, `::TrainConfig`, `::DataConfig` and `::ExperimentConfig`
(fields, defaults and checks). The port keeps its own copy because importing
the JAX package's `core` also imports `jax` (`core/__init__.py` pulls in
`core/mesh.py`), and the machine that runs the port has no JAX. The
attention-selection threshold, which no code of either package reads, is
left out.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Backbone architecture (DeiT-shape ViT)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    # compute dtype for activations; parameters stay fp32
    dtype: str = "float32"
    # run the blocks, predictors and token gathers through the hand-written
    # CUDA kernels (the plain torch versions run for tensors on the CPU)
    use_fused_attention: bool = False
    # 'none' | 'int8': W8A8 projections (ops/quant.py) on the eval-mode,
    # policy-free blocks of the students; training, policy blocks, CLS
    # capture and the teacher stay in the compute dtype
    quant: str = "none"
    # the train step recomputes the student's forward in the backward
    # (activation checkpointing) instead of keeping its activations
    remat: bool = False

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {self.quant!r}")
        if self.quant == "int8" and not self.use_fused_attention:
            raise ValueError(
                "quant='int8' runs through the fused block kernels; set "
                "use_fused_attention=True"
            )

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def deit_tiny(**kw) -> ModelConfig:
    return ModelConfig(embed_dim=192, num_heads=3, **kw)


def deit_small(**kw) -> ModelConfig:
    return ModelConfig(embed_dim=384, num_heads=6, **kw)


def deit_base(**kw) -> ModelConfig:
    return ModelConfig(embed_dim=768, num_heads=12, **kw)


@dataclass(frozen=True)
class PruningConfig:
    """Token-pruning configuration."""

    # encoder layer indices where a pruning stage sits
    pruning_locs: Tuple[int, ...] = (3,)
    # keep ratio per stage, relative to the ORIGINAL spatial token count
    keep_ratios: Tuple[float, ...] = (0.7,)
    # 'topk' | 'gumbel' | 'attn' | 'random'
    selection: str = "topk"
    patch_score_threshold: Optional[float] = None
    small_predictor: bool = False
    predictor_bn: bool = False
    # 'kl_div' | 'mse' | 'bce': also selects softmax or sigmoid keep-probs
    mask_loss_type: str = "kl_div"
    # perturbed (soft) top-k: Monte-Carlo samples and the noise's std at
    # epoch 0 (it decays linearly to 0, `train.schedule.sigma_schedule`)
    topk_num_samples: int = 500
    initial_sigma: float = 0.05
    # train mode gathers the kept tokens as the perturbed top-k indicator
    # times the tokens, so that the selection itself reaches the predictor
    differentiable_topk: bool = False
    pad_keep_to_tile: bool = False
    # mean over heads instead of max when aggregating CLS-attention rows:
    # the teacher's into the mask loss's target, and with selection="attn"
    # the student's own into a stage's scores
    mean_heads: bool = False
    cls_from_teacher: bool = False
    early_exit: bool = False

    def __post_init__(self):
        if len(self.pruning_locs) != len(self.keep_ratios):
            raise ValueError(
                f"pruning_locs ({self.pruning_locs}) and keep_ratios "
                f"({self.keep_ratios}) must have equal length"
            )
        if self.selection not in ("topk", "gumbel", "attn", "random"):
            raise ValueError(f"unknown selection mode {self.selection!r}")
        if self.mask_loss_type not in ("kl_div", "mse", "bce"):
            raise ValueError(f"unknown mask_loss_type {self.mask_loss_type!r}")

    def keep_counts(self, num_patches: int) -> Tuple[int, ...]:
        """Static per-stage kept-token counts K_i = int(N * r_i).

        Ratios are relative to the original spatial token count. With
        pad_keep_to_tile, each K is rounded up so that K+1 (with CLS) fills
        a 16-token tile.
        """
        counts = [int(num_patches * r) for r in self.keep_ratios]
        if self.pad_keep_to_tile:
            counts = [
                min(num_patches, -(-(k + 1) // 16) * 16 - 1) for k in counts
            ]
        return tuple(counts)

    def replace(self, **kw) -> "PruningConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, loss-weight and loop settings."""

    batch_size: int = 64
    epochs: int = 25
    lr: float = 5e-4
    # kept for the flag surface: no schedule reads it, as in the JAX package
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    weight_decay: float = 0.05
    # epochs during which the backbone stays frozen and only the predictor
    # trains: the backbone's lr is 0 and its loss term is gated off
    warmup_epochs: int = 5
    freeze_backbone: bool = False
    # backbone lr after warmup: min(lr * backbone_lr_scale, cosine lr)
    backbone_lr_scale: float = 0.01
    # gradient accumulation: the gradients of this many micro-steps are
    # averaged into one optimizer update (train/optimizer.py)
    grad_accum_steps: int = 1
    # the loop's in-epoch progress cadence: running means every N steps
    log_every_steps: int = 400
    # frozen-teacher output cache (train/teacher_cache.py): the teacher's
    # outputs computed once on the deterministic eval view and looked up
    # every step; needs mixup and cutmix off
    teacher_cache: bool = False
    # device-memory budget of the teacher cache (rows, images and labels)
    # and of the retained validation batches
    device_cache_gb: float = 6.0
    # the JAX package's flattened AdamW: a TPU layout choice with identical
    # updates; accepted, no effect in the port
    flat_optimizer: bool = True
    seed: int = 42
    # the gumbel baseline's loss (`make_dynamic_vit_train_step`): the
    # temperature of its logit KL, the keep-ratio and token-distillation
    # terms with their weights, the CE weight, and the predictors' BCE
    # against the teacher's CLS-attention mask
    softmax_temp: float = 1.0
    use_ratio_loss: bool = False
    ratio_weight: float = 2.0
    use_token_dist_loss: bool = False
    dist_weight: float = 0.5
    cls_weight: float = 1.0
    teacher_cls_loss: bool = False

    def __post_init__(self):
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}"
            )
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DataConfig:
    """The data pipeline's and the augmentations' settings."""

    imgnet_val_dir: str = "/data/imagenet/val"
    num_classes: int = 1000
    # host decode processes (0: in the loader's own thread)
    num_workers: int = 0
    # augmentation; color_jitter is ignored whenever a RandAugment policy is
    # set, as timm ignores it
    color_jitter: float = 0.4
    auto_augment: str = "rand-m9-mstd0.5-inc1"
    smoothing: float = 0.1
    train_interpolation: str = "bicubic"
    repeated_aug: bool = True
    reprob: float = 0.25  # random erasing's probability
    remode: str = "pixel"
    recount: int = 1
    # mixup / cutmix (timm's Mixup)
    mixup: float = 0.8
    cutmix: float = 1.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"
    # eval transform
    eval_resize: int = 256
    eval_crop: int = 224
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level experiment config, the whole flag surface."""

    arch: str = "deit_small"
    model: ModelConfig = field(default_factory=deit_small)
    pruning: PruningConfig = field(default_factory=PruningConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    save_path: str = "test_imgs/"
    wandb: bool = False
    visualize_patch_drop: bool = False
    visualize_cls_attn_evo: bool = False

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
