"""The dense T2T-ViT (port of `dense2sparse_vit_tpu/models/t2t.py::T2TViT`).

A `DeiTBackbone` whose embedding is the tokens-to-token stem
(`nn.t2t.T2TModule`, under `tokens_to_token`) with the fixed sinusoid
position table over the stem's (img_size / 16)^2 tokens, as the JAX model
builds it (`_T2TBase._stem`). Its blocks take drop_path_rate * i /
(depth - 1), the from-scratch recipe's stochastic depth, whose draws come
from the `generator` the caller passes in train mode. `get_average` returns
the mean of the head's logits on every block's normed CLS token (JAX
`models/t2t.py:85-104`). The SE, Ghost and Dense variants are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from dense2sparse_vit_torch.core.config import ModelConfig
from dense2sparse_vit_torch.models.student import DeiTBackbone
from dense2sparse_vit_torch.nn.t2t import T2TModule


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
