"""Token-importance score predictor, LayerNorm variants (port of
`dense2sparse_vit_tpu/nn/predictor.py::PredictorLG`).

  small: in = LN -> Linear(d->d) -> GELU;  out = [LN -> Linear -> GELU] x2
         (d -> d/2 -> d/4), then LN -> Linear(->1)
  large: in = LN -> Linear(d->4d) -> ReLU; out = [LN -> Linear -> ReLU] x4
         (4d -> 2d -> d -> d/2 -> d/4), then LN -> Linear(->1)
Between `in_conv` and `out_conv` the channels split into a per-token local
half and a global half mean-pooled over the tokens. LayerNorm eps is 1e-5
(torch's default, which the reference predictor keeps), not the backbone's
1e-6. The `in_conv` / `out_conv` sequentials give the reference torch key
layout (`score_predictor.{p}.out_conv.{0,1,3,4,6,7}...`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dense2sparse_vit_torch.nn.layers import LayerNorm, Linear, compute_weights
from dense2sparse_vit_torch.ops.predictor import (
    fused_predictor_lg,
    predictor_lg_reference,
)

PREDICTOR_LN_EPS = 1e-5


def _units(c_in, widths, act, final):
    mods = []
    for w in widths:
        mods += [LayerNorm(c_in, eps=PREDICTOR_LN_EPS), Linear(c_in, w),
                 nn.GELU() if act == "gelu" else nn.ReLU()]
        c_in = w
    if final:
        mods += [LayerNorm(c_in, eps=PREDICTOR_LN_EPS), Linear(c_in, 1)]
    return nn.Sequential(*mods)


class PredictorLG(nn.Module):
    """Local-global token scoring head.

    forward returns (scores, keep_probs): raw per-token logits (B, N) and
    keep probabilities (B, N), a softmax over the tokens for the kl_div and
    mse mask losses or a sigmoid for bce. With `use_fused`, in eval mode the
    scores come from `ops.predictor.fused_predictor_lg` (the CUDA kernel for
    a CUDA tensor). In train mode the predictor always runs its plain torch
    layers under autograd, as the JAX package's PredictorLG takes its flax
    path whenever the model is not deterministic (`nn/predictor.py:142-147`):
    the predictor kernel has no backward, there or here.
    """

    def __init__(self, embed_dim: int, small_predictor: bool = False,
                 loss_type: str = "kl_div", use_fused: bool = False):
        super().__init__()
        d = embed_dim
        if small_predictor:
            self.act, in_w, out_w = "gelu", (d,), (d // 2, d // 4)
        else:
            self.act, in_w, out_w = "relu", (4 * d,), (2 * d, d, d // 2, d // 4)
        self.loss_type = loss_type
        self.use_fused = use_fused
        self.in_conv = _units(d, in_w, self.act, final=False)
        self.out_conv = _units(in_w[-1], out_w, self.act, final=True)

    def kernel_weights(self, dtype: torch.dtype) -> dict:
        """The weights in the layout `fused_predictor_lg` takes."""
        mods = [m for m in (*self.in_conv, *self.out_conv)
                if isinstance(m, (LayerNorm, Linear))]
        pairs = [
            (ln.weight, ln.bias, compute_weights(lin, dtype)["weight"], lin.bias)
            for ln, lin in zip(mods[0::2], mods[1::2])
        ]
        return {"units": pairs[:-1], "n_in": len(self.in_conv) // 3,
                "final": pairs[-1], "act": self.act}

    def forward(self, x):
        w = self.kernel_weights(x.dtype)
        if self.use_fused and not self.training:
            scores = fused_predictor_lg(x, w, PREDICTOR_LN_EPS)
        else:
            scores = predictor_lg_reference(x, w, PREDICTOR_LN_EPS)
        if self.loss_type in ("kl_div", "mse"):
            keep_probs = torch.softmax(scores.float(), dim=-1)
        else:
            keep_probs = torch.sigmoid(scores.float())
        return scores, keep_probs.to(scores.dtype)
