"""The DynamicViT-paper baseline student (port of
`dense2sparse_vit_tpu/models/dynamic_vit_default.py`).

- A 2-class (keep, drop) log-softmax predictor per pruning stage, with a
  global half pooled over the tokens the policy still keeps.
- Train mode: cumulative hard Gumbel-softmax keep decisions
  `gumbel(pred)[..., 0:1] * prev_decision` become a (B, N+1) keep policy for
  every later block's policy-masked attention; the sequence never shrinks,
  and the straight-through decisions and dPolicy carry gradient to the
  predictors.
- Eval mode: the top int(N * r) tokens by keep log-probability are
  gathered, and later blocks run on the shorter sequence.

With `use_fused_attention` the blocks and the gather run their kernels
(`ops.block`, `ops.gather`); the predictor is plain torch, as the JAX one
has no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig, PruningConfig
from dense2sparse_vit_torch.models.student import DeiTBackbone
from dense2sparse_vit_torch.nn.layers import LayerNorm, Linear
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens, gather_tokens_reference
from dense2sparse_vit_torch.ops.gumbel import gumbel_softmax_keep
from dense2sparse_vit_torch.ops.topk import topk_keep_indices


class DynamicViTPredictor(nn.Module):
    """Keep/drop predictor with policy-weighted global pooling.

    in_conv = LN -> Linear(d, d) -> GELU; out_conv = Linear(d, d/2) -> GELU
    -> Linear(d/2, d/4) -> GELU -> Linear(d/4, 2), then an fp32 log-softmax
    (the reference torch keys `in_conv.{0,1}`, `out_conv.{0,2,4}`)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        d = embed_dim
        self.in_conv = nn.Sequential(LayerNorm(d, eps=1e-6), Linear(d, d), nn.GELU())
        self.out_conv = nn.Sequential(
            Linear(d, d // 2), nn.GELU(), Linear(d // 2, d // 4), nn.GELU(), Linear(d // 4, 2))

    def forward(self, x: torch.Tensor, policy: torch.Tensor) -> torch.Tensor:
        """x: (B, N, D) spatial tokens; policy: (B, N, 1) keep decisions.
        Returns (B, N, 2) log-probabilities of (keep, drop), in x's dtype."""
        x = self.in_conv(x)
        B, N, C = x.shape
        local_x = x[:, :, : C // 2]
        global_x = (x[:, :, C // 2:] * policy).sum(dim=1, keepdim=True) / (
            policy.sum(dim=1, keepdim=True).clamp_min(1e-6))
        x = torch.cat([local_x, global_x.expand(B, N, C - C // 2)], dim=-1)
        x = self.out_conv(x)
        return F.log_softmax(x.float(), dim=-1).to(x.dtype)


@dataclass
class DynamicViTOutput:
    logits: torch.Tensor
    features: torch.Tensor  # (B, N or K_last, D) final spatial tokens
    # train mode: the cumulative keep decision after the last stage (B, N, 1)
    decisions: Optional[torch.Tensor]
    # per-stage keep probabilities exp(logprob_keep) (B, N_i): the ratio loss's input
    pred_keep_probs: Tuple[torch.Tensor, ...]
    # eval mode: the kept indices in original coordinates (B, K_last)
    kept_idx_orig: Optional[torch.Tensor]


class DynamicViTStudent(DeiTBackbone):
    """See the module docstring. Images are NHWC (B, H, W, 3)."""

    def __init__(self, cfg: ModelConfig, pruning: PruningConfig):
        super().__init__(cfg)
        self.pruning = pruning
        self.score_predictor = nn.ModuleList(
            DynamicViTPredictor(cfg.embed_dim) for _ in pruning.pruning_locs)

    def forward(self, x: torch.Tensor, *, tau: float = 1.0, unpruned: bool = False,
                generator: Optional[torch.Generator] = None) -> DynamicViTOutput:
        """x: (B, H, W, 3) images. In train mode the gumbel noise comes from
        `generator` (on the model's device), which train mode needs unless
        `unpruned`. unpruned: every block dense (no policy, no gather); the
        predictors still run."""
        cfg, pr = self.cfg, self.pruning
        B, N = x.shape[0], cfg.num_patches
        keep = pr.keep_counts(N)
        gather = fused_gather_tokens if cfg.use_fused_attention else gather_tokens_reference
        if self.training and not unpruned and generator is None:
            raise ValueError("train mode draws gumbel noise: pass a torch.Generator")
        self.check_generator(generator)

        x = self.embed(x, generator)
        prev = x.new_ones((B, N, 1))  # the cumulative keep decision
        policy = None  # train mode: the (B, N+1) keep policy
        pred_keep_probs = []
        cur_orig = torch.arange(N, device=x.device).expand(B, N)
        p = 0
        for i, blk in enumerate(self.blocks):
            if i not in pr.pruning_locs:
                x = blk(x, policy, generator=generator)
                continue
            pred = self.score_predictor[p](x[:, 1:], prev)
            keep_logprob = pred[..., 0]
            pred_keep_probs.append(torch.exp(keep_logprob))
            if unpruned:
                x = blk(x, generator=generator)
            elif self.training:
                prev = gumbel_softmax_keep(pred, prev, generator, tau)
                policy = torch.cat([prev.new_ones((B, 1, 1)), prev], dim=1)[..., 0]
                x = blk(x, policy, generator=generator)
            else:
                kept, _ = topk_keep_indices(keep_logprob, keep[p])
                cur_orig = torch.gather(cur_orig, 1, kept)
                x = gather(x, torch.cat([kept.new_zeros(B, 1), kept + 1], dim=1))
                prev = x.new_ones((B, keep[p], 1))
                x = blk(x, generator=generator)
            p += 1

        x = self.norm(x)
        return DynamicViTOutput(
            logits=self.head(x[:, 0]),
            features=x[:, 1:],
            decisions=prev if self.training else None,
            pred_keep_probs=tuple(pred_keep_probs),
            kept_idx_orig=None if self.training else cur_orig,
        )
