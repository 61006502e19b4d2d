"""Hierarchical and ensemble DeiT (port of
`dense2sparse_vit_tpu/models/deit_heads.py`).

  TransformerHead   a conv + BatchNorm residual unit over the patch grid,
                    average pooled, plus a Linear of the CLS token
  HierarchicalDeiT  a TransformerHead on every block but the last: depth
                    logits
  EnsembleDeiT      the same heads, four heads on quarters of the patch
                    sequence and the CLS head: depth + 4 logits, or their
                    mean

Three things are copied as the JAX module has them. The head applies one
conv / BatchNorm pair twice, so in train mode its running statistics are
updated twice a forward. The BatchNorm is flax's (`FlaxBatchNorm2d`): the
batch variance is E[x^2] - E[x]^2, biased, and it is what the running
variance takes (momentum 0.9); torch's BatchNorm2d would take the unbiased
one. And the ensemble's "quadrants" are four contiguous quarters of the
patch sequence, not spatial quadrants.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.models.deit import _DeiTBase
from dense2sparse_vit_torch.nn.layers import Linear, compute_weights


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over the channels
    of an NCHW tensor, in torch's BatchNorm2d key layout. Train mode
    normalises by the batch's fp32 mean and E[x^2] - E[x]^2 (clipped at 0,
    biased) and moves the running statistics 0.1 of the way to them; eval
    mode uses the running statistics. The result is in x's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x.float() - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class TransformerHead(nn.Module):
    """Conv head over the patch grid and a Linear of the CLS token (JAX
    `TransformerHead`): relu(bn(conv(grid))), bn(conv(.)) again with the
    same pair, plus the grid, relu, the spatial mean, plus token_fc(CLS)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1, bias=False)
        self.bn = FlaxBatchNorm2d(dim)
        self.token_fc = Linear(dim, dim)

    def forward(self, x):
        """(B, 1 + n*n, D) -> (B, D)."""
        B, n_tok, D = x.shape
        size = int(round((n_tok - 1) ** 0.5))
        grid = x[:, 1:].reshape(B, size, size, D).permute(0, 3, 1, 2)
        w = compute_weights(self.conv, x.dtype)["weight"]
        feats = F.relu(self.bn(F.conv2d(grid, w, padding=1)))
        feats = self.bn(F.conv2d(feats, w, padding=1))
        feats = F.relu(feats + grid)
        return feats.mean(dim=(2, 3)) + self.token_fc(x[:, 0])


class HierarchicalDeiT(_DeiTBase):
    """A TransformerHead's logits on every block but the last, and the CLS
    head's on the last (JAX `HierarchicalDeiT`): a tuple of depth
    (B, num_classes). The heads' BatchNorms run in the model's mode."""

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        self.transformerheads = nn.ModuleList(
            TransformerHead(cfg.embed_dim) for _ in range(cfg.depth - 1))

    def _layer_logits(self, x, generator):
        """The embedding and blocks with the heads' logits; returns (the
        logits list, the last block's normed output)."""
        self.check_generator(generator)
        x = self._embed(x, generator)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, generator=generator)
            if i < len(self.blocks) - 1:
                outputs.append(self.head(self.transformerheads[i](self.norm(x))))
        return outputs, self.norm(x)

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        outputs, x = self._layer_logits(x, generator)
        return tuple(outputs + [self.head(x[:, 0])])


class EnsembleDeiT(HierarchicalDeiT):
    """HierarchicalDeiT's heads, then four `spatialheads` (a Linear of the
    mean of one contiguous quarter of the patch sequence) and the CLS head
    (JAX `EnsembleDeiT`): depth + 4 logits, or with get_average their
    mean."""

    def __init__(self, cfg: ModelConfig, **fields):
        super().__init__(cfg, **fields)
        self.spatialheads = nn.ModuleList(Linear(cfg.embed_dim, cfg.embed_dim) for _ in range(4))

    def forward(self, x, *, get_average: bool = False,
                generator: Optional[torch.Generator] = None):
        outputs, x = self._layer_logits(x, generator)
        patches = x[:, 1:]
        quad = patches.shape[1] // 4
        for idx, sh in enumerate(self.spatialheads):
            outputs.append(self.head(sh(patches[:, idx * quad:(idx + 1) * quad].mean(dim=1))))
        outputs.append(self.head(x[:, 0]))
        if get_average:
            return torch.stack(outputs, 0).mean(dim=0)
        return tuple(outputs)
