"""Dynamic token-pruning student ViT (port of
`dense2sparse_vit_tpu/models/student.py::DiffPruningStudent`).

A DeiT-shape ViT with score-predictor pruning stages at `pruning_locs`: the
predictor scores the spatial tokens, the top K = int(N * keep_ratio) of them
survive with the CLS token, and later blocks run on the shorter sequence.
With `patch_score_threshold` set (threshold mode) the keep count is the
image's own: each stage keeps the tokens above a cumulative score-mass
threshold as a (B, N+1) keep policy, which replaces the previous stage's,
and every block from the first stage on runs policy-masked attention on
all N+1 tokens; nothing is gathered. A stage's scores come from, in this
order of precedence (JAX `_stage_scores`):
  selection="random"  uniforms from the generator (the JAX package's
                      --random-drop); the model has no predictors;
  cls_from_teacher    the frozen teacher's CLS-attention stack, when the
                      caller passes it (`teacher_cls_attns`), gathered
                      into the current token set;
  selection="attn"    the previous block's CLS-attention row
                      (--attn-selection); a stage at block 0, which no
                      block precedes, takes a predictor;
  else                the stage's predictor (LayerNorm, or BatchNorm with
                      predictor_bn).
With differentiable_topk the train step passes soft_topk: in train mode
the kept tokens are then the perturbed top-k indicator times the spatial
tokens (`ops.perturbed_topk`), so that the selection itself reaches the
predictor; the hard top-k stays the bookkeeping of the losses. With
early_exit, a LayerNorm + Linear head reads the CLS token just before the
first stage (`early_exit_logits`). Every mode runs in eval mode (the JAX
model's `deterministic=True`) and in train mode (`deterministic=False`),
with or without the student's own CLS-attention capture
(`collect_cls_attns`).

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

from dense2sparse_vit_torch.core.config import ModelConfig, PruningConfig
from dense2sparse_vit_torch.nn.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    compute_weights,
    dropout,
    trunc_normal_,
)
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.nn.t2t import TokenPerformer, get_sinusoid_encoding
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens, gather_tokens_reference
from dense2sparse_vit_torch.ops.perturbed_topk import perturbed_topk
from dense2sparse_vit_torch.ops.topk import threshold_keep_mask, topk_keep_indices


def random_scores(shape, generator: torch.Generator) -> torch.Tensor:
    """selection="random"'s scores: fp32 uniforms in [0, 1) on the
    generator's device, as `jax.random.uniform(key, shape)` draws them."""
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


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
    # with early_exit: the early-exit head's (B, num_classes) logits on the
    # CLS token just before the first stage
    early_exit_logits: Optional[torch.Tensor] = None


class DeiTBackbone(nn.Module):
    """The pieces the student and the teacher share: the embedding (a DeiT
    patch embedding, or the `stem` module given, bound as `tokens_to_token`),
    CLS token, position embedding (pos_embed_type "learned": a parameter;
    "sinusoid": the fixed table, a buffer outside the state_dict), the
    blocks, the final norm and the head, with the JAX models' init. The
    position embedding covers `num_tokens` tokens and the CLS token
    (default cfg.num_patches). The blocks take `cfg.quant` unless
    `quantized_blocks` is False (the teacher's). Train mode's elementwise
    dropout (cfg.drop_rate on the embedding and in the blocks,
    cfg.attn_drop_rate on the attention probabilities) draws its masks from
    the generator the forward is given."""

    quantized_blocks = True

    def __init__(self, cfg: ModelConfig, stem: Optional[nn.Module] = None,
                 pos_embed_type: str = "learned", num_tokens: Optional[int] = None):
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
                drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
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

    def check_generator(self, generator: Optional[torch.Generator], draws: bool = False) -> None:
        """Train mode draws random numbers where a block has drop_path > 0,
        elementwise dropout is on, the stem has active dropout (the T2T
        performer) or the caller says it `draws`: raise without a generator
        to draw them from."""
        if not self.training or generator is not None:
            return
        if (draws or self.cfg.drop_rate > 0 or self.cfg.attn_drop_rate > 0
                or any(blk.drop_path.rate > 0 for blk in self.blocks)
                or any(isinstance(m, TokenPerformer) and (m.dp1 > 0 or m.dp2 > 0)
                       for m in self.modules())):
            raise ValueError("train mode draws DropPath scales, dropout masks or selection "
                             "noise: pass a torch.Generator")

    def embed(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, N+1, C) tokens: patches (or the stem's
        tokens), CLS, positions, and in train mode dropout at
        cfg.drop_rate. generator: the stem's and the embedding's dropout
        masks."""
        dtype = getattr(torch, self.cfg.dtype)
        stem = getattr(self, "tokens_to_token", None)
        x = self.patch_embed(x.to(dtype)) if stem is None else stem(x.to(dtype), generator)
        w = compute_weights(self, dtype)
        cls = w["cls_token"].expand(x.shape[0], -1, -1)
        pos = w["pos_embed"] if self.pos_embed_type == "learned" else self.pos_embed.to(dtype)
        x = torch.cat([cls, x], dim=1) + pos
        return dropout(x, self.cfg.drop_rate if self.training else 0.0, generator)


class DiffPruningStudent(DeiTBackbone):
    """See the module docstring. Images are NHWC (B, H, W, 3)."""

    def __init__(self, cfg: ModelConfig, pruning: PruningConfig, stem: Optional[nn.Module] = None,
                 pos_embed_type: str = "learned"):
        super().__init__(cfg, stem, pos_embed_type)
        self.pruning = pruning
        C = cfg.embed_dim
        # the stages that score with a predictor, as the JAX model creates
        # them: none with random selection, with attn selection only a stage
        # at block 0 (which is stage 0); the teacher-CLS selection keeps
        # them (the JAX model's init runs without the teacher's rows)
        if pruning.selection == "random":
            stages = 0
        elif pruning.selection == "attn":
            stages = int(0 in pruning.pruning_locs)
        else:
            stages = len(pruning.pruning_locs)
        self.score_predictor = nn.ModuleList(
            PredictorLG(C, pruning.small_predictor, pruning.mask_loss_type,
                        use_fused=cfg.use_fused_attention, use_bn=pruning.predictor_bn)
            for _ in range(stages)
        )
        if pruning.early_exit:
            self.early_exit_head = nn.Sequential(LayerNorm(C, eps=cfg.layer_norm_eps),
                                                 Linear(C, cfg.num_classes))

    def forward(self, x: torch.Tensor, *, unpruned: bool = False,
                threshold_override: Optional[float] = None,
                collect_cls_attns: bool = True,
                teacher_cls_attns: Optional[torch.Tensor] = None,
                soft_topk: bool = False, sigma=0.05,
                generator: Optional[torch.Generator] = None) -> StudentOutput:
        """x: (B, H, W, 3) images. unpruned: skip every pruning stage.
        threshold_override: replaces `patch_score_threshold` in threshold
        mode (the threshold curriculum's per-epoch value).
        collect_cls_attns: capture every block's CLS-attention rows (the JAX
        model's default; always on with selection="attn", which ranks by
        them). Off, blocks take the whole-block kernels: the train and eval
        steps, the export and the profilers turn it off, as the JAX package's
        do. teacher_cls_attns: the teacher's (B, L, H, N+1) CLS-attention
        stack, which ranks the stages with cls_from_teacher. soft_topk,
        sigma: in train mode, gather the kept tokens as the perturbed top-k
        indicator (pruning.topk_num_samples samples, noise std sigma) times
        the tokens. generator: the source of train mode's DropPath scales,
        dropout masks, random scores and perturbed top-k noise, which train
        mode needs where any is drawn (`check_generator`); random selection
        in eval mode draws from a generator seeded with 0 at each call
        unless one is given (the JAX eval step's PRNGKey(0)).

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
        soft = soft_topk and self.training and threshold is None

        self.check_generator(generator, draws=not unpruned and (soft or pr.selection == "random"))
        if pr.selection == "random" and not self.training and generator is None and not unpruned:
            generator = torch.Generator(device=x.device).manual_seed(0)
        x = self.embed(x, generator)
        teacher_score = None
        if teacher_cls_attns is not None:
            # the teacher's importance in original coordinates: mean over
            # the layers, max (mean) over the heads, renormalised over the
            # spatial tokens
            t = teacher_cls_attns.mean(dim=1)
            t = t.mean(dim=1) if pr.mean_heads else torch.amax(t, dim=1)
            t = t[:, 1:]
            teacher_score = t / t.sum(dim=-1, keepdim=True)
        pred_logits, kept_stage, dropped_stage, keep_masks, cls_attns = [], [], [], [], []
        policy = keep_ratios = early_exit_logits = None
        last_cls = None  # the last capturing block's (B, H, N_layer + 1) CLS rows
        # current spatial position -> original token id
        cur_orig = torch.arange(N, device=x.device).expand(B, N)
        p = 0
        for i, blk in enumerate(self.blocks):
            if i in pr.pruning_locs:
                if pr.early_exit and p == 0:
                    early_exit_logits = self.early_exit_head(x[:, 0])
                if not unpruned:
                    scores_logits, scores = self._stage_scores(p, x, cur_orig, last_cls,
                                                               teacher_score, generator)
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
                        if soft:
                            ind = perturbed_topk(scores, keep[p], generator,
                                                 pr.topk_num_samples, sigma)
                            x = torch.cat([x[:, :1], torch.matmul(ind.to(x.dtype), x[:, 1:])],
                                          dim=1)
                        else:
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
            early_exit_logits=early_exit_logits,
        )

    def _stage_scores(self, p: int, x: torch.Tensor, cur_orig: torch.Tensor,
                      last_cls: Optional[torch.Tensor], teacher_score: Optional[torch.Tensor],
                      generator: Optional[torch.Generator]):
        """(logits, scores) of stage p's spatial tokens (JAX
        `student.py:318-360`): random uniforms; the teacher's scores
        gathered at the current tokens and renormalised; with
        selection="attn" the previous block's CLS rows, max over heads
        (mean with mean_heads), renormalised over the spatial tokens; else
        the stage's predictor. torch.amax splits a tie's gradient evenly,
        as jnp.max does."""
        pr = self.pruning
        if pr.selection == "random":
            rnd = random_scores((x.shape[0], x.shape[1] - 1), generator).to(x.device)
            return rnd, rnd
        if pr.cls_from_teacher and teacher_score is not None:
            s = torch.gather(teacher_score, 1, cur_orig)
            s = s / s.sum(dim=-1, keepdim=True)
            return s, s
        if pr.selection == "attn" and last_cls is not None:
            agg = last_cls.mean(dim=1) if pr.mean_heads else torch.amax(last_cls, dim=1)
            s = agg[:, 1:]
            s = s / s.sum(dim=-1, keepdim=True)
            return s, s
        return self.score_predictor[p](x[:, 1:])
