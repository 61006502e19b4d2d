"""Frozen dense ViT teacher (port of `dense2sparse_vit_tpu/models/teacher.py`).

A plain DeiT-shape ViT whose forward returns the classification logits, the
final spatial tokens and the per-layer stack of CLS-attention rows, which
the mask loss turns into the predictors' target. Its weights follow the
reference torch key layout, as the student's do, so a JAX teacher's params
map onto it through `utils.convert.state_dict_from_jax`.
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.models.student import DeiTBackbone


class ViTTeacher(DeiTBackbone):
    """See the module docstring. Images are NHWC (B, H, W, 3). The teacher
    never quantizes: as the JAX teacher builds its blocks without `quant`
    (`models/teacher.py:58-69`), its blocks stay in the compute dtype
    whatever `cfg.quant` says."""

    quantized_blocks = False

    @torch.no_grad()
    def forward(self, x: torch.Tensor, *, return_head: bool = True):
        """(logits, tokens, cls_attns), computed without gradients (the
        teacher is frozen; the JAX model stops the gradient of its CLS
        attentions and the train step of all three):

          logits (B, num_classes), or the post-norm CLS token without the head;
          tokens (B, N, D), the final spatial tokens, post-norm;
          cls_attns (B, L, H, N+1), every block's CLS row of each head's
            attention probabilities, in the compute dtype.
        """
        x = self.embed(x)
        cls_attns = []
        for blk in self.blocks:
            x, cls_attn = blk(x, return_cls_attn=True)
            cls_attns.append(cls_attn)
        x = self.norm(x)
        logits = self.head(x[:, 0]) if return_head else x[:, 0]
        return logits, x[:, 1:], torch.stack(cls_attns, dim=1)
