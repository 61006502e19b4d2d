"""Policy-masked attention softmax (port of
`dense2sparse_vit_tpu/ops/masked_softmax.py`).

The columns of dropped tokens are zeroed except on the diagonal (a dropped
token still attends to itself, so its row stays a distribution), with eps/N
additive smoothing, in fp32. Threshold pruning and the gumbel baseline keep
every token in the sequence and drop them through this mask instead.
"""

from __future__ import annotations

import torch


def softmax_with_policy(attn: torch.Tensor, policy: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Row-wise softmax of (B, H, N, N) scaled attention logits under a
    (B, N) or (B, N, 1) keep policy (1 = kept); the result in attn's dtype.

    e = exp(s - max_row s) * a, a_ij = pol_j + (1 - pol_j) [i = j], and
    p = (e + eps/N) / (sum_j e + eps). The row max is over every column,
    dropped ones included, and is taken with `torch.amax`, whose gradient
    splits evenly among tied maxima as JAX's does: with eps the result is
    not shift-invariant, so the max path carries gradient.
    """
    in_dtype = attn.dtype
    B, H, N, _ = attn.shape
    ap = policy.reshape(B, N)[:, None, None, :]
    eye = torch.eye(N, dtype=ap.dtype, device=ap.device)
    ap = ap + (1.0 - ap) * eye
    attn = (attn - torch.amax(attn, dim=-1, keepdim=True)).float()
    attn = torch.exp(attn) * ap.float()
    attn = (attn + eps / N) / (attn.sum(dim=-1, keepdim=True) + eps)
    return attn.to(in_dtype)
