"""The T2T-ViT family (port of `dense2sparse_vit_tpu/models/t2t.py`).

`T2TViT` is a `DeiTBackbone` whose embedding is the tokens-to-token stem
(`nn.t2t.T2TModule`, under `tokens_to_token`) with the fixed sinusoid
position table over the stem's (img_size / 16)^2 tokens, as the JAX model
builds it (`_T2TBase._stem`). Its blocks take drop_path_rate * i /
(depth - 1), the from-scratch recipe's stochastic depth, whose draws come
from the `generator` the caller passes in train mode. `get_average` returns
the mean of the head's logits on every block's normed CLS token (JAX
`models/t2t.py:85-104`). At 32 heads of 12 (`t2t_vit_14_resnext`) its
fused blocks take the kernels' path for head widths other than 64.

The three variants share the stem and embedding (`_T2TVariant`) and are
plain torch, as the JAX modules are plain flax with no Pallas kernel:

  T2TViTSE     each block's attention gated by squeeze-excitation: the
               token mean of its output, fc1 (C / 16, no bias), ReLU, fc2
               (no bias), sigmoid, times the output (`_SEAttention`);
  T2TViTGhost  q, k and v at half width, each completed by a per-channel
               scale of itself (`_cheap`), and an MLP of
               x1 || GELU(cheap2 x1) || GELU(cheap3 x1) -> fc2, x1 =
               GELU(fc1 x), exact GELU (`_GhostAttention`, `_GhostMlp`);
  T2TViTDense  DenseNet growth: each layer appends `growth_rate` channels,
               Linear(Block(x)), with LayerNorm + Linear transitions that
               halve the width between stages. Its inner Block is plain
               whatever `use_fused_attention` says, as in JAX: the width
               changes from layer to layer, so no fused kernel is reached.
               Each layer also owns an unused LayerNorm (`norm1`), which the
               JAX model creates and never applies; it is kept so that the
               weights carry over.

Their blocks are named as the JAX modules name them, `blocks_{i}_norm1`
-> `blocks.{i}.norm1` and so on (`utils/convert.py`). The Ghost variant's
cheap products run in the compute dtype; JAX promotes them to fp32 (bf16
times an fp32 parameter). In fp32 the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.models.student import DeiTBackbone
from dense2sparse_vit_torch.nn.layers import (
    Block, LayerNorm, Linear, Mlp, compute_weights, dropout, trunc_normal_)
from dense2sparse_vit_torch.nn.t2t import T2TModule, TokenPerformer, get_sinusoid_encoding
from dense2sparse_vit_torch.ops.block import attention_reference


class T2TViT(DeiTBackbone):
    """Tokens-to-Token ViT. Images are NHWC (B, H, W, 3)."""

    def __init__(self, cfg: ModelConfig, tokens_type: str = "performer", token_dim: int = 64):
        stem = T2TModule(cfg.embed_dim, tokens_type, token_dim, cfg.in_chans)
        super().__init__(cfg, stem, "sinusoid", num_tokens=(cfg.img_size // 16) ** 2)
        self.tokens_type = tokens_type

    def forward(self, x: torch.Tensor, *, get_average: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_classes) logits. generator: the source of train mode's
        DropPath scales and the performer stem's dropout masks."""
        self.check_generator(generator)
        x = self.embed(x, generator)
        block_cls = []
        for blk in self.blocks:
            x = blk(x, generator=generator)
            if get_average:
                block_cls.append(self.norm(x)[:, 0])
        if get_average:
            return torch.stack([self.head(c) for c in block_cls]).mean(dim=0)
        return self.head(self.norm(x)[:, 0])


class _SEAttention(nn.Module):
    """Attention with squeeze-excitation gating (JAX `t2t.py:107-136`)."""

    def __init__(self, dim: int, num_heads: int, reduction: int = 16):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)
        self.se_fc1 = Linear(dim, dim // reduction, bias=False)
        self.se_fc2 = Linear(dim // reduction, dim, bias=False)

    def forward(self, x):
        out = self.proj(attention_reference(self.qkv(x), self.num_heads,
                                            (x.shape[-1] // self.num_heads) ** -0.5))
        y = torch.sigmoid(self.se_fc2(F.relu(self.se_fc1(out.mean(dim=1)))))
        return out * y[:, None, :]


class _GhostAttention(nn.Module):
    """Half-width q, k, v completed by cheap per-channel scales (JAX
    `t2t.py:163-193`)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        half = dim // 2
        self.q = Linear(dim, half, bias=False)
        self.k = Linear(dim, half, bias=False)
        self.v = Linear(dim, half, bias=False)
        self.cheap_q = nn.Parameter(torch.ones(half))
        self.cheap_k = nn.Parameter(torch.ones(half))
        self.cheap_v = nn.Parameter(torch.ones(half))
        self.proj = Linear(dim, dim)

    def forward(self, x):
        w = compute_weights(self, x.dtype)
        qkv = torch.cat([torch.cat([t, t * w[f"cheap_{n}"]], -1)
                         for n, t in (("q", self.q(x)), ("k", self.k(x)), ("v", self.v(x)))], -1)
        return self.proj(attention_reference(qkv, self.num_heads,
                                             (x.shape[-1] // self.num_heads) ** -0.5))


class _GhostMlp(nn.Module):
    """x1 || GELU(cheap2 x1) || GELU(cheap3 x1) -> fc2, x1 = GELU(fc1 x)
    (JAX `t2t.py:196-215`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, dim)
        self.cheap2 = nn.Parameter(torch.ones(dim))
        self.cheap3 = nn.Parameter(torch.ones(dim))
        self.fc2 = Linear(3 * dim, dim)

    def forward(self, x):
        w = compute_weights(self, x.dtype)

        def gelu(t):
            return F.gelu(t.float()).to(x.dtype)

        x1 = gelu(self.fc1(x))
        return self.fc2(torch.cat([x1, gelu(x1 * w["cheap2"]), gelu(x1 * w["cheap3"])], -1))


class _PreNormBlock(nn.Module):
    """x + attn(norm1 x), then x + mlp(norm2 x): the SE and Ghost blocks."""

    def __init__(self, dim: int, eps: float, attn: nn.Module, mlp: nn.Module):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = attn
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = mlp

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _T2TVariant(nn.Module):
    """The stem, CLS token and fixed sinusoid positions the SE, Ghost and
    Dense variants share (JAX `_T2TBase._stem`), their final norm and head,
    their init, and the SE and Ghost forward: the blocks in turn."""

    def __init__(self, cfg: ModelConfig, tokens_type: str, token_dim: int, width: int):
        super().__init__()
        self.cfg = cfg
        self.tokens_type = tokens_type
        C = cfg.embed_dim
        self.tokens_to_token = T2TModule(C, tokens_type, token_dim, cfg.in_chans)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        n = (cfg.img_size // 16) ** 2
        self.register_buffer("pos_embed", torch.from_numpy(get_sinusoid_encoding(n + 1, C)),
                             persistent=False)
        self.norm = LayerNorm(width, eps=cfg.layer_norm_eps)
        self.head = Linear(width, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX models' init: truncated-normal (std 0.02) linear and conv
        weights and CLS token, zero biases, unit LayerNorms and cheap
        scales, the performer's projection redrawn."""
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
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("cheap"):
                nn.init.ones_(p)
        trunc_normal_(self.cls_token, generator)
        return self

    def embed(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, N + 1, C): the stem's tokens, CLS,
        the sinusoid positions, and train mode's dropout at cfg.drop_rate."""
        dtype = getattr(torch, self.cfg.dtype)
        drops = self.training and (self.cfg.drop_rate > 0 or self.tokens_type == "performer")
        if drops and generator is None:
            raise ValueError("train mode draws dropout masks: pass a torch.Generator")
        x = self.tokens_to_token(x.to(dtype), generator)
        cls = compute_weights(self, dtype)["cls_token"].expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        return dropout(x, self.cfg.drop_rate if self.training else 0.0, generator)

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        """(B, num_classes) logits; generator: train mode's dropout masks."""
        x = self.embed(x, generator)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])


class T2TViTSE(_T2TVariant):
    """T2T-ViT with squeeze-excitation attention. Images are NHWC."""

    FIELDS = ("tokens_type", "token_dim")

    def __init__(self, cfg: ModelConfig, tokens_type: str = "performer", token_dim: int = 64):
        super().__init__(cfg, tokens_type, token_dim, cfg.embed_dim)
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.blocks = nn.ModuleList(
            _PreNormBlock(C, eps, _SEAttention(C, cfg.num_heads), Mlp(C, int(C * cfg.mlp_ratio)))
            for _ in range(cfg.depth))


class T2TViTGhost(_T2TVariant):
    """T2T-ViT with Ghost attention and MLP. Images are NHWC."""

    FIELDS = ("tokens_type", "token_dim")

    def __init__(self, cfg: ModelConfig, tokens_type: str = "performer", token_dim: int = 64):
        super().__init__(cfg, tokens_type, token_dim, cfg.embed_dim)
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.blocks = nn.ModuleList(
            _PreNormBlock(C, eps, _GhostAttention(C, cfg.num_heads), _GhostMlp(C))
            for _ in range(cfg.depth))


class _DenseLayer(nn.Module):
    """One growth step: x || dense(inner(x)); `norm1` is the JAX layer's
    LayerNorm that is created and never applied."""

    def __init__(self, dim: int, cfg: ModelConfig, growth: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.inner = Block(dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                           layer_norm_eps=cfg.layer_norm_eps)
        self.dense = Linear(dim, growth)

    def forward(self, x):
        return torch.cat([x, self.dense(self.inner(x))], dim=-1)


class _Transition(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = LayerNorm(dim, eps=eps)
        self.dense = Linear(dim, dim // 2)

    def forward(self, x):
        return self.dense(self.norm(x))


class T2TViTDense(_T2TVariant):
    """T2T-ViT with DenseNet channel growth (JAX `t2t.py:237-280`). Images
    are NHWC."""

    FIELDS = ("tokens_type", "token_dim", "growth_rate", "block_config")

    def __init__(self, cfg: ModelConfig, tokens_type: str = "performer", token_dim: int = 64,
                 growth_rate: int = 64, block_config: Tuple[int, ...] = (3, 4, 6, 3)):
        dims, dim = [], cfg.embed_dim
        for s, n in enumerate(block_config):
            for _ in range(n):
                dims.append(dim)
                dim += growth_rate
            if s != len(block_config) - 1:
                dims.append(-dim)  # a transition from dim
                dim //= 2
        super().__init__(cfg, tokens_type, token_dim, dim)
        self.growth_rate = growth_rate
        self.block_config = tuple(block_config)
        self.blocks = nn.ModuleList(_DenseLayer(d, cfg, growth_rate) for d in dims if d > 0)
        self.transition = nn.ModuleList(_Transition(-d, cfg.layer_norm_eps)
                                         for d in dims if d < 0)

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        x = self.embed(x, generator)
        layers = iter(self.blocks)
        for s, n in enumerate(self.block_config):
            for _ in range(n):
                x = next(layers)(x)
            if s < len(self.transition):
                x = self.transition[s](x)
        return self.head(self.norm(x)[:, 0])
