"""Static-shape token selection (port of `dense2sparse_vit_tpu/ops/topk.py`).

The plain token gather is `ops.gather.gather_tokens_reference`, beside its
kernel.
"""

from __future__ import annotations

import torch


def topk_keep_indices(scores: torch.Tensor, k: int):
    """Top-k token selection with index bookkeeping.

    Args:
      scores: (B, N) per-token keep scores (higher = more important).
      k: number of tokens to keep.

    Returns:
      (kept, dropped): int64 indices of shape (B, k) and (B, N-k), each
      sorted ascending. Equal scores rank by lowest index first, as
      `jax.lax.top_k` does: the ranking is a stable descending sort
      (`torch.topk` promises no order among ties, and bf16 keep-probabilities
      tie often).
    """
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    kept = torch.sort(order[:, :k], dim=-1).values
    dropped = torch.sort(order[:, k:], dim=-1).values
    return kept, dropped


def mask_from_scores(scores: torch.Tensor, keep_ratio: float) -> torch.Tensor:
    """(B, N) mask in the dtype of `scores`, 1 at the top int(N * keep_ratio)
    scores of each row and 0 elsewhere; equal scores rank by lowest index,
    as `jax.lax.top_k` does."""
    k = int(scores.shape[1] * keep_ratio)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros_like(scores)
    return mask.scatter_(1, order[:, :k], 1.0)


def threshold_keep_mask(scores: torch.Tensor, threshold: float):
    """Keep mask from a cumulative score-mass threshold.

    Sorts each row ascending (stably, as `jnp.argsort`), takes the fp32
    prefix sums and keeps every token whose prefix mass exceeds `threshold`:
    the least important tail holding at most `threshold` of the mass is
    dropped. Keep counts vary per image, so the result is a mask for
    policy-masked attention and the sequence keeps its length.

    Returns (mask, keep_ratios): the (B, N) {0, 1} mask in the dtype of
    `scores` and the (B,) kept fractions.
    """
    N = scores.shape[1]
    val, order = torch.sort(scores, dim=-1, stable=True)
    th = (torch.cumsum(val.float(), dim=-1) > threshold).to(scores.dtype)
    mask = torch.zeros_like(scores).scatter_(1, order, th)
    return mask, th.sum(dim=-1) / N
