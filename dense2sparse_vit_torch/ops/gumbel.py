"""Gumbel-softmax keep/drop decisions (port of `dense2sparse_vit_tpu/ops/gumbel.py`).

The gumbel baseline's training path takes `gumbel(pred, hard)[..., 0:1] *
prev_decision`, `pred` being a 2-class log-softmax over (keep, drop) per
token: hard decisions forward, the soft ones' gradient backward
(straight-through). The noise comes from an explicit `torch.Generator`
through `uniform_noise`, a function of its own, so that a test can hand
both this module and the JAX one the same noise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def uniform_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """fp32 uniforms in [1e-20, 1), on the generator's device, as
    `jax.random.uniform(key, shape, minval=1e-20, maxval=1.0)` draws them."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return u + 1e-20


def gumbel_softmax(logits: torch.Tensor, generator: torch.Generator, tau: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """Sample the Gumbel-softmax over the last axis, in logits' dtype: the
    logits perturbed by Gumbel(0, 1) noise over `tau`, softmaxed; with
    `hard`, the one-hot of the first maximum forward (`jnp.argmax`'s and
    `torch.argmax`'s tie rule) with the soft sample's gradient."""
    u = uniform_noise(logits.shape, generator).to(logits.device)
    gumbels = -torch.log(-torch.log(u + 1e-20))
    y_soft = torch.softmax((logits.float() + gumbels) / tau, dim=-1)
    if not hard:
        return y_soft.to(logits.dtype)
    y_hard = F.one_hot(torch.argmax(y_soft, dim=-1), logits.shape[-1]).to(y_soft.dtype)
    return (y_hard + y_soft - y_soft.detach()).to(logits.dtype)


def gumbel_softmax_keep(keep_drop_logits: torch.Tensor, prev_decision: torch.Tensor,
                        generator: torch.Generator, tau: float = 1.0) -> torch.Tensor:
    """(B, N, 1) cumulative keep decision: the hard gumbel decision on the
    (B, N, 2) (keep, drop) logits, times the previous stage's (B, N, 1)."""
    decision = gumbel_softmax(keep_drop_logits, generator, tau=tau, hard=True)
    return decision[:, :, 0:1] * prev_decision
