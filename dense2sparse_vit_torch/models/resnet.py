"""Drop-ResNet (port of `dense2sparse_vit_tpu/models/resnet.py`).

A ResNet-50 whose forward can zero a random spatial mask, shared over the
batch and the channels, before stage `drop_layer` (1-4; 5: after the
last), to study how it leans on spatial information beside the ViT
patch-drop experiments. Images are NHWC, as everywhere in the port; the
network runs NCHW inside (`F.conv2d` with the torch OIHW kernels: JAX uses
XLA's convolution, no Pallas kernel). The BatchNorms are flax's
(`models.deit_heads.FlaxBatchNorm2d`: momentum 0.9, eps 1e-5, the biased
E[x^2] - E[x]^2 batch variance), in train mode normalising by the batch
and moving the running statistics, in eval mode by those. Max pooling pads
by one on each side, as flax's [(1, 1), (1, 1)].

The spatial mask is uniform(H, W) > drop_percent, its uniforms from
`spatial_drop_draws` and the forward's explicit `torch.Generator` (the JAX
model's `feature_drop` rng), so that a test can hand both packages the same
draws. Key layout: torchvision's (`layer1.0.conv1.weight`,
`layer1.0.downsample.0.weight`, `bn1.running_mean`, `fc.weight`), onto
which `utils/convert.py` maps the JAX names (`layer1_0/downsample_conv`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.models.deit_heads import FlaxBatchNorm2d
from dense2sparse_vit_torch.nn.layers import Linear, compute_weights


def spatial_drop_draws(shape, generator: torch.Generator) -> torch.Tensor:
    """The spatial drop's (H, W) uniforms in [0, 1), fp32, on the
    generator's device."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def _conv(conv: nn.Conv2d, x):
    w = compute_weights(conv, x.dtype)
    return F.conv2d(x, w["weight"], w.get("bias"), stride=conv.stride, padding=conv.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each with BatchNorm, and a projected
    residual where the shape changes (JAX `resnet.py:17-48`)."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(out)
        self.downsample = None
        if in_ch != out or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out, 1, stride=stride, bias=False),
                                            FlaxBatchNorm2d(out))

    def forward(self, x):
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        res = x if self.downsample is None else self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + res)


class DropResNet(nn.Module):
    """ResNet with an optional pre-stage spatial drop (JAX `resnet.py:51-94`)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 1000,
                 dtype: str = "float32"):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = str(dtype).replace("torch.", "")
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FlaxBatchNorm2d(64)
        ch = 64
        for s, n in enumerate(self.stage_sizes):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(ch, 64 * 2 ** s, 2 if s > 0 and b == 0 else 1))
                ch = 64 * 2 ** s * Bottleneck.expansion
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
        self.fc = Linear(ch, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """He-normal convolutions (fan in), unit BatchNorm scales, zero
        biases and running means, unit running variances, a truncated-normal
        (std 0.02) classifier."""
        from dense2sparse_vit_torch.nn.layers import trunc_normal_

        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
        trunc_normal_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)
        return self

    def forward(self, x: torch.Tensor, *, drop_percent: float = 0.0, drop_layer: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, C) images -> (B, num_classes) logits; with drop_percent
        > 0, the (H, W) mask zeroes the input of stage `drop_layer` (5: the
        last stage's output), its uniforms drawn from `generator`."""
        x = x.to(getattr(torch, self.dtype)).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(_conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)

        def maybe_drop(x, stage):
            if drop_layer != stage or drop_percent <= 0.0:
                return x
            if generator is None:
                raise ValueError("the spatial drop draws its mask: pass a torch.Generator")
            keep = spatial_drop_draws(x.shape[2:], generator).to(x.device) > drop_percent
            return x * keep.to(x.dtype)[None, None]

        for s in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{s + 1}")(maybe_drop(x, s + 1))
        x = maybe_drop(x, 5)
        return self.fc(x.mean(dim=(2, 3)))


def drop_resnet50(num_classes: int = 1000, **kw) -> DropResNet:
    """The drop_resnet50 factory (JAX `resnet.py:97-100`)."""
    return DropResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)
