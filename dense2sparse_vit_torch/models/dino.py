"""The DINO family (port of `dense2sparse_vit_tpu/models/dino.py`).

  DINOViT           the DINO backbone: the CLS feature (num_classes 0, the
                    released checkpoints) or the head's logits; the last
                    block's CLS rows with `return_selfattention`
  DINOPredictorViT  one pruning stage at `pruning_location` with a
                    two-class log-softmax predictor (`_DinoPredictor`): in
                    train mode hard Gumbel keep decisions as the blocks' keep
                    policy from there on, in eval mode the top int(keep_ratio
                    N) patches gathered
  DINODistilledViT  the backbone with a second (shape / distillation) token
  DINOMaskedViT     external (N, 2) mask logits -> hard Gumbel keep
                    decisions, returned beside every block's CLS logits (the
                    decisions are not applied, as in the JAX model)

All over the port's `models.deit._DeiTBase`; the registry builds them at
patch 16 or 8. The Gumbel noise comes from the forward's `generator`
(`ops.gumbel.uniform_noise`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.models.deit import _DeiTBase
from dense2sparse_vit_torch.nn.layers import LayerNorm, Linear
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens, gather_tokens_reference
from dense2sparse_vit_torch.ops.gumbel import gumbel_softmax
from dense2sparse_vit_torch.ops.topk import topk_keep_indices


class _DinoPredictor(nn.Module):
    """Two-class log-softmax local / global predictor (JAX `_DinoPredictor`),
    in the reference torch key layout: in_conv (LayerNorm eps 1e-6, Linear
    d -> d, GELU), then the first half of each token's features beside the
    token mean of the second half, and out_conv (Linear d -> d/2, GELU,
    Linear -> d/4, GELU, Linear -> 2); the log-softmax in fp32, returned in
    the input's dtype."""

    def __init__(self, embed_dim: int):
        super().__init__()
        d = embed_dim
        self.in_conv = nn.Sequential(LayerNorm(d, eps=1e-6), Linear(d, d), nn.GELU())
        self.out_conv = nn.Sequential(Linear(d, d // 2), nn.GELU(), Linear(d // 2, d // 4),
                                      nn.GELU(), Linear(d // 4, 2))

    def forward(self, x):
        """(B, N, d) -> (B, N, 2) (keep, drop) log-probabilities."""
        x = self.in_conv(x)
        d = x.shape[-1]
        local = x[:, :, : d // 2]
        glob = x[:, :, d // 2:].mean(dim=1, keepdim=True).expand(-1, x.shape[1], -1)
        x = self.out_conv(torch.cat([local, glob], dim=-1))
        return F.log_softmax(x.float(), dim=-1).to(x.dtype)


class DINOViT(_DeiTBase):
    """The DINO backbone (JAX `DINOViT`)."""

    def forward(self, x, *, return_selfattention: bool = False,
                generator: Optional[torch.Generator] = None):
        """The normed CLS token (B, C) with num_classes 0, else the head's
        logits; with return_selfattention the last block's (B, H, N+1) CLS
        rows."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        if return_selfattention:
            return self._last_cls_attn(x, generator)
        for blk in self.blocks:
            x = blk(x, generator=generator)
        cls = self.norm(x)[:, 0]
        return self.head(cls) if self.cfg.num_classes > 0 else cls


class DINOPredictorViT(_DeiTBase):
    """Single-stage pruning DINO (JAX `DINOPredictorViT`)."""

    FIELDS = _DeiTBase.FIELDS + ("pruning_location", "keep_ratio")
    pruning_location = 0
    keep_ratio = 0.7

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        self.predictor = _DinoPredictor(cfg.embed_dim)

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        """(out, keep_decisions): out the head's logits (the CLS feature
        with num_classes 0); keep_decisions the (B, N, 1) hard Gumbel keep
        decisions of train mode, whose (B, N+1) policy (CLS kept) masks the
        blocks from `pruning_location` on, or None in eval mode, which
        gathers the CLS token and the top int(keep_ratio N) patches by the
        keep log-probability (the gather kernel where the model is fused)."""
        self.check_generator(generator, draws=True)
        x = self._embed(x, generator)
        B = x.shape[0]
        policy = keep = None
        for i, blk in enumerate(self.blocks):
            if i == self.pruning_location:
                pred = self.predictor(x[:, 1:])
                if self.training:
                    keep = gumbel_softmax(pred, generator, hard=True)[..., 0:1]
                    policy = torch.cat([keep.new_ones(B, 1, 1), keep], dim=1)[..., 0]
                else:
                    score = pred[..., 0]
                    kept, _ = topk_keep_indices(score, int(self.keep_ratio * score.shape[1]))
                    idx = torch.cat([kept.new_zeros(B, 1), kept + 1], dim=1)
                    gather = (fused_gather_tokens if self.cfg.use_fused_attention
                              else gather_tokens_reference)
                    x = gather(x, idx)
            x = blk(x, policy, generator=generator)
        cls = self.norm(x)[:, 0]
        return (self.head(cls) if self.cfg.num_classes > 0 else cls), keep


class DINODistilledViT(_DeiTBase):
    """The DINO backbone with a second (shape / distillation) token (JAX
    `DINODistilledViT`)."""

    num_extra_tokens = 2

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        if cfg.num_classes > 0:
            self.head_dist = Linear(cfg.embed_dim, cfg.num_classes)

    def forward(self, x, *, return_selfattention: bool = False,
                generator: Optional[torch.Generator] = None):
        """(CLS, dist): the two heads' logits, or with num_classes 0 the two
        normed tokens; with return_selfattention the last block's CLS
        rows."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        if return_selfattention:
            return self._last_cls_attn(x, generator)
        for blk in self.blocks:
            x = blk(x, generator=generator)
        x = self.norm(x)
        if self.cfg.num_classes > 0:
            return self.head(x[:, 0]), self.head_dist(x[:, 1])
        return x[:, 0], x[:, 1]


class DINOMaskedViT(_DeiTBase):
    """External-mask DINO (JAX `DINOMaskedViT`)."""

    def forward(self, x, mask_logits: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """(every block's CLS logits as a tuple, keep_decisions):
        keep_decisions the (B, N+1, 1) fp32 hard Gumbel decisions on the
        log-softmax of mask_logits, CLS kept, or None without them."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        B = x.shape[0]
        keep = None
        if mask_logits is not None:
            if generator is None:
                raise ValueError("the keep decisions draw Gumbel noise: pass a torch.Generator")
            logits = F.log_softmax(
                mask_logits[None].expand((B,) + tuple(mask_logits.shape)).float(), dim=-1)
            patch_keep = gumbel_softmax(logits, generator, hard=True)[..., 0:1]
            keep = torch.cat([patch_keep.new_ones(B, 1, 1), patch_keep], dim=1)
        outs = []
        for blk in self.blocks:
            x = blk(x, generator=generator)
            outs.append(self.head(self.norm(x)[:, 0]))
        return tuple(outs), keep
