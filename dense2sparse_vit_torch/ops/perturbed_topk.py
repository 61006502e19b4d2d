"""Differentiable perturbed top-k (port of
`dense2sparse_vit_tpu/ops/perturbed_topk.py`; Cordonnier et al.,
"Differentiable Patch Selection for Image Recognition").

Forward: the Monte-Carlo mean, over nS Gaussian perturbations of the scores,
of the one-hot top-k indicator, a (B, k, N) matrix whose rows follow the
kept tokens in ascending order. Backward: the expected noise-gradient
estimator

    dL/dx[b, d] = 1 / (nS sigma) * sum_n sum_j 1[idx(b, n, j) = d] g[b, j, d] z[b, n, d].

Neither pass builds the (B, nS, k, N) one-hot (~6.9 GB in fp32 at B=128,
nS=500, k=137, N=196). The forward counts each (b, j, d) in integers and
scales by 1/nS; the backward scatters g[b, j, idx(b, n, j)] into a (B, nS, N)
buffer (each (b, n, d) has at most one j, so nothing collides), multiplies
by z and sums over n. No float atomics: both passes give the same bits on
every run. For the backward the function keeps z (fp32) and the indices in
the narrowest integer type that holds N. The noise comes from an explicit
`torch.Generator` through `gaussian_noise`, a function of its own, so that a
test can hand both packages the same noise, as `ops.gumbel.uniform_noise`.
"""

from __future__ import annotations

import torch


def gaussian_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """fp32 unit Gaussians on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)


def topk_sample_indices(perturbed: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N) -> (..., k): the indices of the k largest entries of each
    row, equal values ranked by lowest index first (`jax.lax.top_k`'s rule;
    `torch.topk` promises no order among ties), then sorted ascending."""
    order = torch.sort(perturbed, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.sort(order, dim=-1).values


class PerturbedTopK(torch.autograd.Function):
    """(x (B, N) fp32, z (B, nS, N) fp32 noise, sigma 0-d fp32, k) ->
    (B, k, N) fp32 indicator; differentiable in x alone (JAX
    `_perturbed_topk_core`)."""

    @staticmethod
    def forward(ctx, x, z, sigma, k):
        B, N = x.shape
        nS = z.shape[1]
        idx = topk_sample_indices(x[:, None, :] + sigma * z, k)  # (B, nS, k)
        # counts[b, j, d] = #{n : idx[b, n, j] = d}
        lin = (torch.arange(B, device=x.device).view(B, 1, 1) * k
               + torch.arange(k, device=x.device).view(1, 1, k)) * N + idx
        counts = torch.bincount(lin.reshape(-1), minlength=B * k * N)
        ind = counts.view(B, k, N).float() * (1.0 / nS)
        narrow = torch.int16 if N <= torch.iinfo(torch.int16).max else torch.int32
        ctx.save_for_backward(z, sigma, idx.to(narrow))
        return ind

    @staticmethod
    def backward(ctx, g):
        z, sigma, idx = ctx.saved_tensors
        B, nS, N = z.shape
        k = idx.shape[-1]
        idx = idx.long()
        # g[b, j, idx[b, n, j]]: row j of g at each sample's j-th index
        flat = (torch.arange(k, device=g.device).view(1, 1, k) * N + idx).view(B, nS * k)
        g_sel = torch.gather(g.float().reshape(B, k * N), 1, flat).view(B, nS, k)
        spread = torch.zeros((B, nS, N), dtype=torch.float32, device=g.device)
        spread.scatter_(2, idx, g_sel)
        grad = (spread * z).sum(dim=1) / (nS * sigma)
        return grad, None, None, None


def perturbed_topk(x: torch.Tensor, k: int, generator: torch.Generator,
                   num_samples: int = 500, sigma=0.05) -> torch.Tensor:
    """Expected top-k indicator matrix, differentiable in x.

    x: (B, N) scores; k: the number of tokens kept; num_samples: nS, the
    Monte-Carlo samples; sigma: the perturbation's std (a number or a 0-d
    tensor), clamped at 1e-12 as the JAX function clamps it (the schedule
    reaches 0 at the last epoch). The (B, nS, N) noise is drawn from
    `generator` (`gaussian_noise`). Returns the (B, k, N) indicator in x's
    dtype; each row is a kept token's mean one-hot, rows in ascending token
    order.
    """
    B, N = x.shape
    z = gaussian_noise((B, num_samples, N), generator).to(x.device)
    sigma = torch.clamp(torch.as_tensor(sigma, dtype=torch.float32, device=x.device), min=1e-12)
    return PerturbedTopK.apply(x.float(), z, sigma, k).to(x.dtype)
