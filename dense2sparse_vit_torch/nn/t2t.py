"""Tokens-to-Token (T2T) stem (port of `dense2sparse_vit_tpu/nn/t2t.py`).

A copy, not an import: the JAX module imports jax. The stem is plain torch;
it has no kernel in the JAX package either.

  - `get_sinusoid_encoding`: the fixed (1, n_position, d_hid) table;
  - `unfold`: torch's soft split on NHWC input, (B, L, C*k*k) tokens in
    channel-major patch order (c, kh, kw), as the JAX package's patch
    extraction orders them;
  - `TokenTransformer`: single-head attention from the input width to
    `in_dim` with V as the skip, then a ratio-1 MLP;
  - `TokenPerformer`: FAVOR+ linear attention with positive random features
    exp(w^T x - |x|^2 / 2) / sqrt(m) on a frozen orthogonal projection `w`
    (the JAX param `prm_w`), the features in fp32, V as the skip, and
    dropout 0.1 on both branches in train mode;
  - `T2TModule`: the performer, transformer and convolution stems.

Module and parameter names follow the reference torch key layout
(`tokens_to_token.attention1.kqv.weight`, `...attention1.w`, ...), which
`utils/convert.py` maps the JAX params onto. Train-mode dropout draws from
the explicit `torch.Generator` the caller passes, as DropPath does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.nn.layers import LayerNorm, Linear, Mlp, compute_weights


def get_sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """(1, n_position, d_hid) fixed sinusoid table (JAX `nn/t2t.py:36`)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


def unfold(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, C*k*k): torch's Unfold on NHWC input, the
    features in (c, kh, kw) order."""
    patches = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding, stride=stride)
    return patches.transpose(1, 2)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Elementwise dropout with the mask drawn from `generator`: kept
    elements divided by keep = 1 - rate in x's dtype, the rest zero (flax's
    Dropout)."""
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=generator.device).bernoulli_(keep, generator=generator)
    return torch.where(mask.to(x.device, torch.bool), x / keep, torch.zeros_like(x))


class _TokenAttention(nn.Module):
    """The transformer unit's attention, under the reference's `attn` name."""

    def __init__(self, dim: int, in_dim: int, qkv_bias: bool):
        super().__init__()
        self.qkv = Linear(dim, 3 * in_dim, bias=qkv_bias)
        self.proj = Linear(in_dim, in_dim)


class TokenTransformer(nn.Module):
    """T2T transformer unit: single-head attention dim -> in_dim with V as
    the skip, then x + Mlp(LN x). The scores are scaled by the INPUT width's
    head dim, (dim / num_heads)^-0.5, as the reference does (JAX
    `nn/t2t.py:76-91`)."""

    def __init__(self, dim: int, in_dim: int, num_heads: int = 1, mlp_ratio: float = 1.0,
                 qkv_bias: bool = False):
        super().__init__()
        if num_heads != 1:
            raise ValueError("the T2T transformer unit has one head of in_dim")
        self.scale = (dim // num_heads) ** -0.5
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = _TokenAttention(dim, in_dim, qkv_bias)
        self.norm2 = LayerNorm(in_dim, eps=1e-5)
        self.mlp = Mlp(in_dim, int(in_dim * mlp_ratio))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        q, k, v = self.attn.qkv(self.norm1(x)).chunk(3, dim=-1)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.scale
        p = torch.softmax(s, dim=-1).to(x.dtype)
        x = v + self.attn.proj(torch.matmul(p, v))
        return x + self.mlp(self.norm2(x))


class TokenPerformer(nn.Module):
    """FAVOR+ linear-attention T2T unit (JAX `nn/t2t.py:112`)."""

    def __init__(self, dim: int, in_dim: int, kernel_ratio: float = 0.5, dp1: float = 0.1,
                 dp2: float = 0.1):
        super().__init__()
        self.m = int(in_dim * kernel_ratio)
        self.dp1, self.dp2 = dp1, dp2
        self.kqv = Linear(dim, 3 * in_dim)
        self.proj = Linear(in_dim, in_dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(in_dim, eps=1e-5)
        # the reference's Sequential(fc1, GELU, fc2, Dropout): keys mlp.0, mlp.2
        self.mlp = nn.Sequential(Linear(in_dim, in_dim), nn.GELU(), Linear(in_dim, in_dim))
        # the frozen random projection (reference `w`, JAX `prm_w`); a model's
        # init_weights draws it again from the model's generator
        self.w = nn.Parameter(torch.empty(self.m, in_dim), requires_grad=False)
        self.reset_projection(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_projection(self, generator: torch.Generator):
        """w = orthogonal rows times sqrt(m), drawn from `generator`."""
        nn.init.orthogonal_(self.w, generator=generator)
        self.w.mul_(math.sqrt(self.m))

    def _features(self, t):
        """exp(w^T t - |t|^2 / 2) / sqrt(m), in fp32."""
        t = t.float()
        td = (t * t).sum(dim=-1, keepdim=True) / 2
        return torch.exp(t @ self.w.float().t() - td) / math.sqrt(self.m)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        drop = self.training and (self.dp1 > 0 or self.dp2 > 0)
        if drop and generator is None:
            raise ValueError("the performer's train-mode dropout draws its masks: "
                             "pass a torch.Generator")
        k, q, v = self.kqv(self.norm1(x)).chunk(3, dim=-1)  # the reference's order
        kp, qp = self._features(k), self._features(q)
        d = torch.einsum("bti,bi->bt", qp, kp.sum(dim=1))[..., None]
        kptv = torch.einsum("bin,bim->bnm", v.float(), kp)
        y = (torch.einsum("bti,bni->btn", qp, kptv) / (d + 1e-8)).to(x.dtype)
        y = self.proj(y)
        if self.training and self.dp1 > 0:
            y = dropout(y, self.dp1, generator)
        x = v + y
        z = self.mlp[0](self.norm2(x))
        z = self.mlp[2](F.gelu(z.float()).to(z.dtype))
        if self.training and self.dp2 > 0:
            z = dropout(z, self.dp2, generator)
        return x + z


class T2TModule(nn.Module):
    """Tokens-to-token stem (JAX `nn/t2t.py:172`): NHWC images -> (B, L,
    embed_dim) tokens, L = (H / 16)^2. tokens_type "performer" or
    "transformer": three soft splits with a T2T unit after each of the
    first two, then the `project` Linear; "convolution": three strided
    convolutions (`soft_split0`, `soft_split1`, `project`)."""

    def __init__(self, embed_dim: int = 768, tokens_type: str = "performer",
                 token_dim: int = 64, in_chans: int = 3):
        super().__init__()
        if tokens_type not in ("performer", "transformer", "convolution"):
            raise ValueError(f"unknown tokens_type {tokens_type!r}")
        self.tokens_type = tokens_type
        td = token_dim
        if tokens_type == "convolution":
            self.soft_split0 = nn.Conv2d(in_chans, td, 7, stride=4, padding=2)
            self.soft_split1 = nn.Conv2d(td, td, 3, stride=2, padding=1)
            self.project = nn.Conv2d(td, embed_dim, 3, stride=2, padding=1)
            return
        if tokens_type == "transformer":
            self.attention1 = TokenTransformer(in_chans * 49, td)
            self.attention2 = TokenTransformer(td * 9, td)
        else:
            self.attention1 = TokenPerformer(in_chans * 49, td)
            self.attention2 = TokenPerformer(td * 9, td)
        self.project = Linear(td * 9, embed_dim)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, H, W, C_in) in the compute dtype. generator: the source of
        the performer's train-mode dropout masks."""
        if self.tokens_type == "convolution":
            for conv in (self.soft_split0, self.soft_split1, self.project):
                w = compute_weights(conv, x.dtype)
                x = F.conv2d(x.permute(0, 3, 1, 2), w["weight"], w["bias"],
                             stride=conv.stride, padding=conv.padding).permute(0, 2, 3, 1)
            return x.reshape(x.shape[0], -1, x.shape[-1])
        x = self.attention1(unfold(x, 7, 4, 2), generator)
        x = self.attention2(unfold(self._grid(x), 3, 2, 1), generator)
        return self.project(unfold(self._grid(x), 3, 2, 1))

    @staticmethod
    def _grid(x):
        B, L, C = x.shape
        g = math.isqrt(L)
        return x.reshape(B, g, g, C)
