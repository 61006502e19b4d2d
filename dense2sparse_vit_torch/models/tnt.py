"""Transformer-in-Transformer (port of `dense2sparse_vit_tpu/models/tnt.py`).

Each block runs an inner transformer on every patch's pixel tokens, adds
their projection to the patch tokens (not to the CLS token: JAX's
`.at[:, 1:].add`), then an outer transformer on the patch tokens:

  PixelEmbed  a 7x7 stride-4 conv (`pixel_embed.proj`), its output cut into
              ceil(patch / 4)^2-pixel patches by `nn.t2t.unfold`
              (channel-major, (B P, c, np, np)), plus `pixel_pos`, as
              (B P, np^2, c) tokens;
  patches     LayerNorm (`norm1_proj`), Linear (`proj`), LayerNorm
              (`norm2_proj`) of each patch's pixel tokens, CLS, `patch_pos`;
  TNTAttention q and k at `hidden_dim`, v at the input width, scale
              (hidden_dim / heads)^-0.5 (the inner heads are 6 or 10 wide).

Plain torch: the JAX module calls no Pallas kernel. Images are NHWC.
Parameter names follow the JAX module's, `blocks_{i}_attn_in` ->
`blocks.{i}.attn_in`, `pixel_embed_proj` -> `pixel_embed.proj`
(`utils/convert.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.nn.layers import (
    LayerNorm, Linear, Mlp, compute_weights, dropout, trunc_normal_)
from dense2sparse_vit_torch.nn.t2t import unfold


class TNTAttention(nn.Module):
    """qk at hidden_dim, v at the input width (JAX `tnt.py:22-50`)."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.qk = Linear(dim, 2 * hidden_dim, bias=qkv_bias)
        self.v = Linear(dim, dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        H, hd = self.num_heads, self.hidden_dim // self.num_heads
        q, k = self.qk(x).view(B, N, 2, H, hd).permute(2, 0, 3, 1, 4).unbind(0)
        v = self.v(x).view(B, N, H, C // H).transpose(1, 2)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        p = torch.softmax(s, dim=-1).to(x.dtype)
        return self.proj(torch.matmul(p, v).transpose(1, 2).reshape(B, N, C))


class _PixelEmbed(nn.Module):
    def __init__(self, in_chans: int, in_dim: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, in_dim, 7, stride=stride, padding=3)


class TNTBlock(nn.Module):
    """The inner transformer on pixel tokens, their projection added to the
    patch tokens, the outer transformer (JAX `tnt.py:108-146`)."""

    def __init__(self, cfg: ModelConfig, in_dim: int, in_num_head: int, num_pixel: int):
        super().__init__()
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.norm_in = LayerNorm(in_dim, eps=eps)
        self.attn_in = TNTAttention(in_dim, in_dim, in_num_head, cfg.qkv_bias)
        self.norm_mlp_in = LayerNorm(in_dim, eps=eps)
        self.mlp_in = Mlp(in_dim, in_dim * 4)
        self.norm1_proj = LayerNorm(in_dim, eps=eps)
        self.proj = Linear(in_dim * num_pixel, C)
        self.norm_out = LayerNorm(C, eps=eps)
        self.attn_out = TNTAttention(C, C, cfg.num_heads, cfg.qkv_bias)
        self.norm_mlp = LayerNorm(C, eps=eps)
        self.mlp = Mlp(C, int(C * cfg.mlp_ratio))

    def forward(self, pixel_embed, patch_embed):
        B = patch_embed.shape[0]
        pixel_embed = pixel_embed + self.attn_in(self.norm_in(pixel_embed))
        pixel_embed = pixel_embed + self.mlp_in(self.norm_mlp_in(pixel_embed))
        inject = self.proj(self.norm1_proj(pixel_embed).reshape(B, patch_embed.shape[1] - 1, -1))
        patch_embed = torch.cat([patch_embed[:, :1], patch_embed[:, 1:] + inject], dim=1)
        patch_embed = patch_embed + self.attn_out(self.norm_out(patch_embed))
        patch_embed = patch_embed + self.mlp(self.norm_mlp(patch_embed))
        return pixel_embed, patch_embed


class TNT(nn.Module):
    """TNT backbone (JAX `tnt.py:53-149`): NHWC images -> (B, num_classes)."""

    FIELDS = ("in_dim", "in_num_head", "first_stride")

    def __init__(self, cfg: ModelConfig, in_dim: int = 24, in_num_head: int = 4,
                 first_stride: int = 4):
        super().__init__()
        self.cfg = cfg
        self.in_dim = in_dim
        self.new_ps = -(-cfg.patch_size // first_stride)
        num_pixel = self.new_ps ** 2
        C, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.pixel_embed = _PixelEmbed(cfg.in_chans, in_dim, first_stride)
        self.pixel_pos = nn.Parameter(torch.zeros(1, in_dim, self.new_ps, self.new_ps))
        self.norm1_proj = LayerNorm(in_dim * num_pixel, eps=eps)
        self.proj = Linear(in_dim * num_pixel, C)
        self.norm2_proj = LayerNorm(C, eps=eps)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.patch_pos = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, C))
        self.blocks = nn.ModuleList(TNTBlock(cfg, in_dim, in_num_head, num_pixel)
                                    for _ in range(cfg.depth))
        self.norm = LayerNorm(C, eps=eps)
        self.head = Linear(C, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX model's init: truncated-normal (std 0.02) linear and conv
        weights and position and CLS parameters, zero biases, unit
        LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                trunc_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for p in (self.pixel_pos, self.cls_token, self.patch_pos):
            trunc_normal_(p, generator)
        return self

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None):
        """(B, num_classes) logits. generator: train mode's dropout mask at
        cfg.drop_rate on the patch embedding (the JAX model's only
        dropout)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        drop = cfg.drop_rate if self.training else 0.0
        if drop > 0 and generator is None:
            raise ValueError("train mode draws dropout masks: pass a torch.Generator")
        B, P, ps = x.shape[0], cfg.num_patches, self.new_ps
        w = compute_weights(self.pixel_embed.proj, dtype)
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w["weight"], w["bias"],
                     stride=self.pixel_embed.proj.stride, padding=3)
        pix = unfold(y.permute(0, 2, 3, 1), ps, ps, 0).reshape(B * P, self.in_dim, ps, ps)
        wp = compute_weights(self, dtype)
        pixel_embed = (pix + wp["pixel_pos"]).reshape(B * P, self.in_dim, ps * ps).transpose(1, 2)
        pe = self.norm2_proj(self.proj(self.norm1_proj(pixel_embed.reshape(B, P, -1))))
        patch_embed = torch.cat([wp["cls_token"].expand(B, -1, -1), pe], dim=1) + wp["patch_pos"]
        patch_embed = dropout(patch_embed, drop, generator)
        for blk in self.blocks:
            pixel_embed, patch_embed = blk(pixel_embed, patch_embed)
        return self.head(self.norm(patch_embed)[:, 0])
