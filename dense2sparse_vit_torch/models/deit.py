"""The DeiT family (port of `dense2sparse_vit_tpu/models/deit.py`).

The backbones of the JAX module, as `nn.Module`s over the port's `Block` and
`PatchEmbed` (through `models.student.DeiTBackbone`), with its class names:

  DeiT                 plain backbone; `return_selfattention` gives the last
                       block's CLS row of the attention probabilities
  DistilledDeiT        CLS + distillation token, two heads; per-layer
                       (cls, dist) tokens with `return_per_layer`
  VanillaDeiT          per-layer CLS logits, and a random block-level patch
                       drop (`block_index`, `drop_rate`)
  NonSpatialDeiT       no position embedding
  MaskedDistilledDeiT  external (N, 2) mask logits -> hard Gumbel keep
                       decisions zeroing dropped tokens from `mask_block` on
  MaskPredictorDeiT    an inline two-layer predictor and Gumbel keep
                       decisions at `mask_block` (default depth - 2)

and `interpolate_pos_encoding`, which resizes the position embedding's grid
to the input's patch count, and `forward_crops`, the multi-crop forward.

Images are NHWC. Train mode is the module's `training` flag (the JAX
modules' `deterministic=False`). Every random draw comes from the
`generator` a forward is given: the patch drop's scores (`patch_drop_scores`)
and the Gumbel noise (`ops.gumbel.uniform_noise`), which a test can replace
to hand both packages the same draws. With `quant="int8"` the blocks take the
int8 kernel in eval mode, as the JAX Block does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.models.student import DeiTBackbone
from dense2sparse_vit_torch.nn.layers import Linear, compute_weights, dropout, trunc_normal_
from dense2sparse_vit_torch.ops.gumbel import gumbel_softmax


def interpolate_pos_encoding(pos_embed: torch.Tensor, n_spatial: int,
                             n_extra: int = 1) -> torch.Tensor:
    """Resize the grid part of a (1, n_extra + N_old, D) position embedding
    to n_spatial tokens, as the JAX function does: bilinear with half-pixel
    centres and, as `jax.image.resize` by default, antialiased (a shrinking
    grid is filtered by a triangle as wide as the scale, which torch's
    `antialias=True` computes too; a growing one is plain bilinear), in
    fp32, returned in the input's dtype."""
    n_old = pos_embed.shape[1] - n_extra
    if n_old == n_spatial:
        return pos_embed
    gs_old = int(round(n_old ** 0.5))
    gs_new = int(round(n_spatial ** 0.5))
    D = pos_embed.shape[-1]
    grid = pos_embed[0, n_extra:].float().reshape(gs_old, gs_old, D).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(gs_new, gs_new), mode="bilinear", align_corners=False,
                         antialias=True)
    grid = grid[0].permute(1, 2, 0).reshape(1, gs_new * gs_new, D).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :n_extra], grid], dim=1)


def _slice(out, a: int, b: int):
    """Rows a..b of every tensor in a (nested tuple or list of) output(s)."""
    if isinstance(out, torch.Tensor):
        return out[a:b]
    if isinstance(out, (tuple, list)):
        return type(out)(_slice(o, a, b) for o in out)
    return out


def forward_crops(model: nn.Module, crops: Sequence[torch.Tensor], **kwargs):
    """Multi-crop forward (JAX `forward_crops`): the crops, each (B_i, H_i,
    W_i, 3), grouped by resolution in order of first appearance, one forward
    per group on their concatenation, and each crop's rows of the output
    handed back in the input order. Returns the list of outputs."""
    groups: dict = {}
    for i, c in enumerate(crops):
        groups.setdefault(tuple(c.shape[1:3]), []).append(i)
    outputs = [None] * len(crops)
    for idxs in groups.values():
        out = model(torch.cat([crops[i] for i in idxs], dim=0), **kwargs)
        offset = 0
        for i in idxs:
            s = crops[i].shape[0]
            outputs[i] = _slice(out, offset, offset + s)
            offset += s
    return outputs


def patch_drop_scores(shape, generator: torch.Generator) -> torch.Tensor:
    """VanillaDeiT's patch-drop scores: fp32 uniforms in [0, 1) on the
    generator's device, as `jax.random.uniform(key, shape)` draws them."""
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


class _DeiTBase(DeiTBackbone):
    """The embedding, blocks, norm and head the family shares (JAX
    `_DeiTBase`): `num_extra_tokens` learned tokens ahead of the patches
    (CLS; with 2, the distillation token `dist_token` too), a learned
    position embedding over them and the patches unless `use_pos_embed` is
    False, resized to the input's patch count; no head where
    cfg.num_classes is 0 (a headless DINO backbone). FIELDS are the keyword
    arguments of the class itself, as the JAX dataclass fields the registry
    hands it."""

    FIELDS = ("num_extra_tokens", "use_pos_embed")
    num_extra_tokens = 1
    use_pos_embed = True

    def __init__(self, cfg: ModelConfig, **fields):
        for k, v in fields.items():
            if k not in self.FIELDS:
                raise TypeError(f"{type(self).__name__} takes no field {k!r}")
            setattr(self, k, v)
        # (a headless model's head is made at one class, then dropped)
        super().__init__(cfg if cfg.num_classes > 0 else cfg.replace(num_classes=1))
        self.cfg = cfg
        C = cfg.embed_dim
        del self.pos_embed
        if self.use_pos_embed:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + self.num_extra_tokens, C))
        else:
            self.pos_embed_type = "none"  # (DeiTBackbone.init_weights then draws none)
        if self.num_extra_tokens == 2:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.num_classes <= 0:
            del self.head

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The backbone's init, the extra tokens and the position embedding
        truncated normal (std 0.02), BatchNorms at unit scale and zero
        shift with unit running variance."""
        super().init_weights(generator)
        if self.num_extra_tokens == 2:
            trunc_normal_(self.dist_token, generator)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def _embed(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, H, W, 3) -> (B, extra + N, C): the extra tokens, the patches,
        the position embedding resized to N patches, and in train mode
        dropout at cfg.drop_rate."""
        dtype = getattr(torch, self.cfg.dtype)
        x = self.patch_embed(x.to(dtype))
        B, n_spatial = x.shape[0], x.shape[1]
        w = compute_weights(self, dtype)
        toks = [w["cls_token"].expand(B, -1, -1)]
        if self.num_extra_tokens == 2:
            toks.append(w["dist_token"].expand(B, -1, -1))
        x = torch.cat(toks + [x], dim=1)
        if self.use_pos_embed:
            pe = interpolate_pos_encoding(self.pos_embed, n_spatial, self.num_extra_tokens)
            x = x + pe.to(dtype)
        return dropout(x, self.cfg.drop_rate if self.training else 0.0, generator)

    def _last_cls_attn(self, x, generator):
        """The blocks up to the last, then the last block's (B, H, N) CLS
        row of the attention probabilities."""
        for blk in self.blocks[:-1]:
            x = blk(x, generator=generator)
        return self.blocks[-1](x, return_cls_attn=True, generator=generator)[1]


class DeiT(_DeiTBase):
    """Plain DeiT backbone (JAX `DeiT`)."""

    def forward(self, x, *, return_selfattention: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, num_classes) logits; with return_selfattention the last
        block's (B, H, N+1) CLS rows instead."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        if return_selfattention:
            return self._last_cls_attn(x, generator)
        for blk in self.blocks:
            x = blk(x, generator=generator)
        return self.head(self.norm(x)[:, 0])


class DistilledDeiT(_DeiTBase):
    """CLS + distillation token DeiT (JAX `DistilledDeiT`)."""

    num_extra_tokens = 2

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        self.head_dist = Linear(cfg.embed_dim, cfg.num_classes)

    def forward(self, x, *, return_per_layer: bool = False,
                generator: Optional[torch.Generator] = None):
        """(cls_logits, dist_logits); with return_per_layer also every
        block's (CLS, dist) output tokens as a tuple of pairs."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        per_layer = []
        for blk in self.blocks:
            x = blk(x, generator=generator)
            if return_per_layer:
                per_layer.append((x[:, 0], x[:, 1]))
        x = self.norm(x)
        cls_logits, dist_logits = self.head(x[:, 0]), self.head_dist(x[:, 1])
        if return_per_layer:
            return cls_logits, dist_logits, tuple(per_layer)
        return cls_logits, dist_logits


class VanillaDeiT(_DeiTBase):
    """Per-layer CLS logits and a random block-level patch drop (JAX
    `VanillaDeiT`)."""

    def forward(self, x, *, drop_best: bool = False, block_index: int = 0,
                drop_rate: float = 0.0, generator: Optional[torch.Generator] = None):
        """The head's logits on every block's normed CLS token, a tuple of
        depth (B, num_classes). With drop_rate > 0, before block
        `block_index` each image keeps its n - int(n drop_rate) patches of
        highest uniform score (drawn from `generator` in either mode, as the
        JAX model draws from its 'patch_drop' stream), in ascending order,
        and the CLS token. drop_best is accepted and unused, as in JAX."""
        self.check_generator(generator)
        if drop_rate > 0.0 and generator is None:
            raise ValueError("the patch drop draws its scores: pass a torch.Generator")
        x = self._embed(x, generator)
        outs = []
        for i, blk in enumerate(self.blocks):
            if drop_rate > 0.0 and i == block_index:
                B, n_sp = x.shape[0], x.shape[1] - 1
                keep = n_sp - int(n_sp * drop_rate)
                scores = patch_drop_scores((B, n_sp), generator).to(x.device)
                idx = torch.sort(torch.topk(scores, keep, dim=-1).indices, dim=-1).values
                idx = torch.cat([idx.new_zeros(B, 1), idx + 1], dim=1)
                x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
            x = blk(x, generator=generator)
            outs.append(self.head(self.norm(x)[:, 0]))
        return tuple(outs)


class NonSpatialDeiT(_DeiTBase):
    """DeiT without a position embedding (JAX `NonSpatialDeiT`)."""

    use_pos_embed = False

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        self.check_generator(generator)
        x = self._embed(x, generator)
        for blk in self.blocks:
            x = blk(x, generator=generator)
        return self.head(self.norm(x)[:, 0])


def _keep_tokens(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """x (B, 2 + N, C) times the (B, N, 1) keep decisions, the CLS and
    distillation tokens kept."""
    ones = keep.new_ones(x.shape[0], 2, 1)
    return x * torch.cat([ones, keep], dim=1).to(x.dtype)


class MaskedDistilledDeiT(_DeiTBase):
    """Distilled DeiT with external per-patch mask logits (JAX
    `MaskedDistilledDeiT`): the (N, 2) logits become hard Gumbel keep
    decisions that zero the dropped tokens from block `mask_block` on."""

    FIELDS = _DeiTBase.FIELDS + ("mask_block",)
    num_extra_tokens = 2
    mask_block = 7

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        self.head_dist = Linear(cfg.embed_dim, cfg.num_classes)

    def forward(self, x, mask_logits: Optional[torch.Tensor] = None, *, tau: float = 1.0,
                hard: bool = True, generator: Optional[torch.Generator] = None):
        """(cls_logits, dist_logits, keep): keep the (B, N, 1) decisions in
        mask_logits' dtype, None without mask_logits. The Gumbel noise is
        drawn from `generator` in either mode."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        keep = None
        if mask_logits is not None:
            if generator is None:
                raise ValueError("the keep decisions draw Gumbel noise: pass a torch.Generator")
            logits = mask_logits[None].expand((x.shape[0],) + tuple(mask_logits.shape))
            keep = gumbel_softmax(logits, generator, tau=tau, hard=hard)[..., 0:1]
        for i, blk in enumerate(self.blocks):
            if keep is not None and i == self.mask_block:
                x = _keep_tokens(x, keep)
            x = blk(x, generator=generator)
        x = self.norm(x)
        return self.head(x[:, 0]), self.head_dist(x[:, 1]), keep


class MaskPredictorDeiT(_DeiTBase):
    """Distilled DeiT with an inline predictor (JAX `MaskPredictorDeiT`):
    at block `mask_block` (default depth - 2) `predictor_fc1` (C -> C/2),
    exact GELU and `predictor_fc2` (-> 2) score the patches, and their hard
    Gumbel keep decisions zero the dropped ones."""

    FIELDS = _DeiTBase.FIELDS + ("mask_block",)
    num_extra_tokens = 2
    mask_block = None

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        C = cfg.embed_dim
        self.head_dist = Linear(C, cfg.num_classes)
        self.predictor_fc1 = Linear(C, C // 2)
        self.predictor_fc2 = Linear(C // 2, 2)

    def forward(self, x, *, tau: float = 1.0, generator: Optional[torch.Generator] = None):
        """(cls_logits, dist_logits, keep), keep the (B, N, 1) fp32
        decisions. The Gumbel noise is drawn from `generator` in either
        mode."""
        if generator is None:
            raise ValueError("the keep decisions draw Gumbel noise: pass a torch.Generator")
        x = self._embed(x, generator)
        mask_block = self.cfg.depth - 2 if self.mask_block is None else self.mask_block
        keep = None
        for i, blk in enumerate(self.blocks):
            if i == mask_block:
                logits = self.predictor_fc2(F.gelu(self.predictor_fc1(x[:, 2:])))
                keep = gumbel_softmax(logits.float(), generator, tau=tau, hard=True)[..., 0:1]
                x = _keep_tokens(x, keep)
            x = blk(x, generator=generator)
        x = self.norm(x)
        return self.head(x[:, 0]), self.head_dist(x[:, 1]), keep
