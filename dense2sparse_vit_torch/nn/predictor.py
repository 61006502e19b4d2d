"""Token-importance score predictor (port of
`dense2sparse_vit_tpu/nn/predictor.py::PredictorLG`), with LayerNorm or
BatchNorm units.

  small: in = LN -> Linear(d->d) -> GELU;  out = [LN -> Linear -> GELU] x2
         (d -> d/2 -> d/4), then LN -> Linear(->1)
  large: in = LN -> Linear(d->4d) -> ReLU; out = [LN -> Linear -> ReLU] x4
         (4d -> 2d -> d -> d/2 -> d/4), then LN -> Linear(->1)
With `use_bn` (the reference's --predictor-bn) every LayerNorm is a
`BatchNormLayer` and every activation a ReLU. Between `in_conv` and
`out_conv` the channels split into a per-token local half and a global half
mean-pooled over the tokens. LayerNorm eps is 1e-5 (torch's default, which
the reference predictor keeps), not the backbone's 1e-6. The `in_conv` /
`out_conv` sequentials give the reference torch key layout
(`score_predictor.{p}.out_conv.{0,1,3,4,6,7}...`, a BatchNorm's under
`...{m}.bn.`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.nn.layers import LayerNorm, Linear, compute_weights
from dense2sparse_vit_torch.ops.predictor import (
    fused_predictor_lg,
    local_global,
    predictor_lg_reference,
)
from dense2sparse_vit_torch.parallel import all_reduce_sum, group_size

PREDICTOR_LN_EPS = 1e-5


class BatchNormLayer(nn.Module):
    """The reference's BatchNormLayer: `nn.BatchNorm1d` over the channels of
    (B, N, C) tokens, the batch and token axes reduced together, in fp32,
    returning the input's dtype (JAX `nn/predictor.py::TorchBatchNorm`). In
    train mode the batch is normalised with its biased variance and the
    running statistics take the unbiased one, momentum 0.1, eps 1e-5; eval
    mode normalises with the running statistics. The module sits under
    `bn`, as the reference's keys have it.

    `process_group` (set by `set_batch_norm_group`): the data group of a DDP
    step. With more than one rank there, train mode takes its statistics
    over the global batch, as the JAX layer does under GSPMD: the fp32 sum,
    sum of squares and count of the rows are summed over the group
    (differentiably, so the gradient flows through the global moments as
    through one batch), the rows normalised with the global biased
    variance, and the running variance updated with the unbiased one over
    the global count."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.bn = nn.BatchNorm1d(features, eps=eps, momentum=momentum)
        self.process_group = None

    def forward(self, x):
        bn = self.bn
        if self.training:
            bn.num_batches_tracked.add_(1)
            if group_size(self.process_group) > 1:
                return self._global_batch_norm(x)
        y = F.batch_norm(x.float().reshape(-1, x.shape[-1]), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=self.training, momentum=bn.momentum,
                         eps=bn.eps)
        return y.view(x.shape).to(x.dtype)

    def _global_batch_norm(self, x):
        bn = self.bn
        rows = x.float().reshape(-1, x.shape[-1])
        c = rows.shape[1]
        moments = torch.cat([rows.sum(0), (rows * rows).sum(0),
                             rows.new_full((1,), float(rows.shape[0]))])
        moments = all_reduce_sum(moments, self.process_group)
        n = moments[2 * c]
        mean = moments[:c] / n
        var = moments[c:2 * c] / n - mean * mean
        y = (rows - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * var * (n / (n - 1)))
        return y.view(x.shape).to(x.dtype)


def set_batch_norm_group(module: nn.Module, group) -> None:
    """Give every `BatchNormLayer` under `module` the data group its train
    mode takes the batch statistics over (None: its own rows)."""
    for m in module.modules():
        if isinstance(m, BatchNormLayer):
            m.process_group = group


def _units(c_in, widths, act, final, use_bn):
    def norm(c):
        return BatchNormLayer(c) if use_bn else LayerNorm(c, eps=PREDICTOR_LN_EPS)

    mods = []
    for w in widths:
        mods += [norm(c_in), Linear(c_in, w), nn.GELU() if act == "gelu" else nn.ReLU()]
        c_in = w
    if final:
        mods += [norm(c_in), Linear(c_in, 1)]
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
    the predictor kernel has no backward, there or here. The BatchNorm
    predictor (`use_bn`) never takes the kernel, as in the JAX package: its
    layers run as they are, with batch statistics in train mode (updating
    the running ones) and the running statistics in eval mode.
    """

    def __init__(self, embed_dim: int, small_predictor: bool = False,
                 loss_type: str = "kl_div", use_fused: bool = False, use_bn: bool = False):
        super().__init__()
        d = embed_dim
        if small_predictor:
            in_w, out_w = (d,), (d // 2, d // 4)
            self.act = "relu" if use_bn else "gelu"
        else:
            self.act, in_w, out_w = "relu", (4 * d,), (2 * d, d, d // 2, d // 4)
        self.loss_type = loss_type
        self.use_fused = use_fused
        self.use_bn = use_bn
        self.in_conv = _units(d, in_w, self.act, final=False, use_bn=use_bn)
        self.out_conv = _units(in_w[-1], out_w, self.act, final=True, use_bn=use_bn)

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
        if self.use_bn:
            scores = self.out_conv(local_global(self.in_conv(x)))[..., 0]
        elif self.use_fused and not self.training:
            scores = fused_predictor_lg(x, self.kernel_weights(x.dtype), PREDICTOR_LN_EPS)
        else:
            scores = predictor_lg_reference(x, self.kernel_weights(x.dtype), PREDICTOR_LN_EPS)
        if self.loss_type in ("kl_div", "mse"):
            keep_probs = torch.softmax(scores.float(), dim=-1)
        else:
            keep_probs = torch.sigmoid(scores.float())
        return scores, keep_probs.to(scores.dtype)
