"""Dynamic token-pruning student ViT (port of
`dense2sparse_vit_tpu/models/student.py::DiffPruningStudent`).

A DeiT-shape ViT with score-predictor pruning stages at `pruning_locs`: the
predictor scores the spatial tokens, the top K = int(N * keep_ratio) of them
survive with the CLS token, and later blocks run on the shorter sequence.
With `patch_score_threshold` set (threshold mode) the keep count is the
image's own: each stage keeps the tokens above a cumulative score-mass
threshold as a (B, N+1) keep policy, which replaces the previous stage's,
and every block from the first stage on runs policy-masked attention on
all N+1 tokens; nothing is gathered. With selection="attn" (the JAX
package's --attn-selection) a stage ranks the tokens by the previous
block's CLS-attention row instead of a predictor, and the model has no
predictors. This port has these modes with the LayerNorm predictors, in
eval mode (the JAX model's `deterministic=True`) and in train mode
(`deterministic=False`), with or without the student's own CLS-attention
capture (`collect_cls_attns`); the random and teacher-CLS selections, soft
top-k, the BatchNorm predictor and the early-exit head are not ported yet
and are rejected at construction.

The embedding is backbone-agnostic, as the JAX model's (`stem`,
`pos_embed_type`): the DeiT patch embedding with a learned position
embedding by default, or a T2T stem (`nn.t2t.T2TModule`, bound as
`tokens_to_token`) with the fixed sinusoid table, which gives the pruned
T2T-ViT (`t2t_vit_14_student`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from dense2sparse_vit_torch.core.config import ModelConfig, PruningConfig, reject_unported
from dense2sparse_vit_torch.nn.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    compute_weights,
    trunc_normal_,
)
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.nn.t2t import TokenPerformer, get_sinusoid_encoding
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens, gather_tokens_reference
from dense2sparse_vit_torch.ops.topk import threshold_keep_mask, topk_keep_indices


@dataclass
class StudentOutput:
    logits: torch.Tensor  # (B, num_classes)
    features: torch.Tensor  # (B, K_last, D) final spatial tokens, post-norm
    # per-stage predictor logits, each (B, N_stage); N_stage shrinks
    pred_logits: Tuple[torch.Tensor, ...]
    # per-stage kept / dropped indices in stage-local coordinates, ascending
    kept_idx: Tuple[torch.Tensor, ...]
    dropped_idx: Tuple[torch.Tensor, ...]
    # the last stage's kept indices in original token coordinates (B, K_last)
    kept_idx_orig: Optional[torch.Tensor]
    # with collect_cls_attns: every capturing block's CLS-attention rows over
    # the spatial tokens, (B, H, N_layer) each; widths shrink at the stages.
    # Blocks under a threshold policy capture nothing.
    cls_attns: Tuple[torch.Tensor, ...] = ()
    # threshold mode: the last stage's (B, N) spatial keep mask and (B,) kept
    # fractions, and every stage's (B, N) mask, which chain the mask loss's
    # target from stage to stage as kept_idx does in top-k mode
    keep_mask: Optional[torch.Tensor] = None
    keep_ratios: Optional[torch.Tensor] = None
    keep_masks: Tuple[torch.Tensor, ...] = ()


class DeiTBackbone(nn.Module):
    """The pieces the student and the teacher share: the embedding (a DeiT
    patch embedding, or the `stem` module given, bound as `tokens_to_token`),
    CLS token, position embedding (pos_embed_type "learned": a parameter;
    "sinusoid": the fixed table, a buffer outside the state_dict), the
    blocks, the final norm and the head, with the JAX models' init. The
    position embedding covers `num_tokens` tokens and the CLS token
    (default cfg.num_patches). The blocks take `cfg.quant` unless
    `quantized_blocks` is False (the teacher's). Elementwise dropout is not
    ported and is rejected."""

    quantized_blocks = True

    def __init__(self, cfg: ModelConfig, stem: Optional[nn.Module] = None,
                 pos_embed_type: str = "learned", num_tokens: Optional[int] = None):
        reject_unported({
            "drop_rate / attn_drop_rate": cfg.drop_rate > 0 or cfg.attn_drop_rate > 0,
        })
        if pos_embed_type not in ("learned", "sinusoid"):
            raise ValueError(f"unknown pos_embed_type {pos_embed_type!r}")
        super().__init__()
        self.cfg = cfg
        self.pos_embed_type = pos_embed_type
        C = cfg.embed_dim
        if stem is None:
            self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, C)
        else:
            self.tokens_to_token = stem
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        n = cfg.num_patches if num_tokens is None else num_tokens
        if pos_embed_type == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, C))
        else:
            table = torch.from_numpy(get_sinusoid_encoding(n + 1, C))
            self.register_buffer("pos_embed", table, persistent=False)
        self.blocks = nn.ModuleList(
            Block(
                C, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale,
                drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                layer_norm_eps=cfg.layer_norm_eps,
                use_fused=cfg.use_fused_attention,
                quant=cfg.quant if self.quantized_blocks else "none",
            )
            for i in range(cfg.depth)
        )
        self.norm = LayerNorm(C, eps=cfg.layer_norm_eps)
        self.head = Linear(C, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """DeiT init, as the JAX model's: truncated-normal (std 0.02) linear,
        conv, CLS and learned position weights; zero biases; unit
        LayerNorms; a T2T performer's frozen projection orthogonal times
        sqrt(m). The generator must be on the parameters' device."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                trunc_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, TokenPerformer):
                m.reset_projection(generator)
        trunc_normal_(self.cls_token, generator)
        if self.pos_embed_type == "learned":
            trunc_normal_(self.pos_embed, generator)
        return self

    def check_generator(self, generator: Optional[torch.Generator]) -> None:
        """Train mode draws random numbers where a block has drop_path > 0
        or the stem has active dropout (the T2T performer): raise without a
        generator to draw them from."""
        if not self.training or generator is not None:
            return
        if (any(blk.drop_path.rate > 0 for blk in self.blocks)
                or any(isinstance(m, TokenPerformer) and (m.dp1 > 0 or m.dp2 > 0)
                       for m in self.modules())):
            raise ValueError("train mode draws DropPath scales or dropout masks: pass a "
                             "torch.Generator")

    def embed(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, N+1, C) tokens: patches (or the stem's
        tokens), CLS, positions. generator: the stem's dropout masks."""
        dtype = getattr(torch, self.cfg.dtype)
        stem = getattr(self, "tokens_to_token", None)
        x = self.patch_embed(x.to(dtype)) if stem is None else stem(x.to(dtype), generator)
        w = compute_weights(self, dtype)
        cls = w["cls_token"].expand(x.shape[0], -1, -1)
        pos = w["pos_embed"] if self.pos_embed_type == "learned" else self.pos_embed.to(dtype)
        return torch.cat([cls, x], dim=1) + pos


class DiffPruningStudent(DeiTBackbone):
    """See the module docstring. Images are NHWC (B, H, W, 3)."""

    def __init__(self, cfg: ModelConfig, pruning: PruningConfig, stem: Optional[nn.Module] = None,
                 pos_embed_type: str = "learned"):
        attn = pruning.selection == "attn"
        reject_unported({
            "selection == 'random'": pruning.selection == "random",
            "predictor_bn": pruning.predictor_bn,
            "early_exit": pruning.early_exit,
            "cls_from_teacher": pruning.cls_from_teacher,
            # the JAX model falls back to a predictor where no block precedes
            "selection == 'attn' with a stage at block 0": attn and 0 in pruning.pruning_locs,
        })
        super().__init__(cfg, stem, pos_embed_type)
        self.pruning = pruning
        C = cfg.embed_dim
        self.score_predictor = nn.ModuleList(
            PredictorLG(C, pruning.small_predictor, pruning.mask_loss_type,
                        use_fused=cfg.use_fused_attention)
            for _ in ([] if attn else pruning.pruning_locs)
        )

    def forward(self, x: torch.Tensor, *, unpruned: bool = False,
                threshold_override: Optional[float] = None,
                collect_cls_attns: bool = True,
                generator: Optional[torch.Generator] = None) -> StudentOutput:
        """x: (B, H, W, 3) images. unpruned: skip every pruning stage.
        threshold_override: replaces `patch_score_threshold` in threshold
        mode (the threshold curriculum's per-epoch value).
        collect_cls_attns: capture every block's CLS-attention rows (the JAX
        model's default; always on with selection="attn", which ranks by
        them). Off, blocks take the whole-block kernels: the train and eval
        steps, the export and the profilers turn it off, as the JAX package's
        do. generator: the source of train mode's DropPath scales and the
        T2T performer stem's dropout masks, which train mode needs where
        either is active (`check_generator`).

        In train mode the blocks take the trainable kernels (fused) and the
        predictors their plain layers; the gather is differentiable in both
        modes, with the scatter-add as its backward. Threshold masks come
        from the scores without their gradient, as in the JAX model; attn
        scores keep theirs, so the mask loss reaches the blocks through the
        CLS rows."""
        cfg, pr = self.cfg, self.pruning
        collect = collect_cls_attns or pr.selection == "attn"
        B, N = x.shape[0], cfg.num_patches
        keep = pr.keep_counts(N)
        gather = fused_gather_tokens if cfg.use_fused_attention else gather_tokens_reference
        threshold = pr.patch_score_threshold
        if threshold_override is not None:
            threshold = threshold_override

        self.check_generator(generator)
        x = self.embed(x, generator)
        pred_logits, kept_stage, dropped_stage, keep_masks, cls_attns = [], [], [], [], []
        policy = keep_ratios = None  # threshold mode: the (B, N+1) keep policy
        last_cls = None  # the last capturing block's (B, H, N_layer + 1) CLS rows
        # current spatial position -> original token id
        cur_orig = torch.arange(N, device=x.device).expand(B, N)
        p = 0
        for i, blk in enumerate(self.blocks):
            if i in pr.pruning_locs:
                if not unpruned:
                    scores_logits, scores = self._stage_scores(p, x, last_cls)
                    pred_logits.append(scores_logits)
                    if threshold is not None:
                        mask, keep_ratios = threshold_keep_mask(scores.detach(), threshold)
                        keep_masks.append(mask)
                        policy = torch.cat([mask.new_ones(B, 1), mask], dim=1)
                    else:
                        kept, dropped = topk_keep_indices(scores, keep[p])
                        kept_stage.append(kept)
                        dropped_stage.append(dropped)
                        cur_orig = torch.gather(cur_orig, 1, kept)
                        idx = torch.cat([kept.new_zeros(B, 1), kept + 1], dim=1)
                        x = gather(x, idx)
                p += 1
            if collect and policy is None:
                x, last_cls = blk(x, return_cls_attn=True, generator=generator)
                cls_attns.append(last_cls[:, :, 1:])
            else:
                x = blk(x, policy, generator=generator)

        x = self.norm(x)
        return StudentOutput(
            logits=self.head(x[:, 0]),
            features=x[:, 1:],
            pred_logits=tuple(pred_logits),
            kept_idx=tuple(kept_stage),
            dropped_idx=tuple(dropped_stage),
            kept_idx_orig=cur_orig if kept_stage else None,
            cls_attns=tuple(cls_attns),
            keep_mask=None if policy is None else policy[:, 1:],
            keep_ratios=keep_ratios,
            keep_masks=tuple(keep_masks),
        )

    def _stage_scores(self, p: int, x: torch.Tensor, last_cls: Optional[torch.Tensor]):
        """(logits, scores) of stage p's spatial tokens: the predictor's, or
        with selection="attn" the previous block's CLS rows, max over heads
        (mean with mean_heads), renormalised over the spatial tokens, as both
        (JAX `student.py:341-349`). torch.amax splits a tie's gradient evenly,
        as jnp.max does."""
        pr = self.pruning
        if pr.selection == "attn":
            agg = last_cls.mean(dim=1) if pr.mean_heads else torch.amax(last_cls, dim=1)
            s = agg[:, 1:]
            s = s / s.sum(dim=-1, keepdim=True)
            return s, s
        return self.score_predictor[p](x[:, 1:])
