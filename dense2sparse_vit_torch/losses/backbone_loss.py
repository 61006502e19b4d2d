"""Backbone (classification + distillation) loss (port of
`dense2sparse_vit_tpu/losses/backbone_loss.py`).

Class cross-entropy (soft-target under mixup), logit KL against the
teacher, and the final-token KL with the teacher's tokens gathered at the
student's kept tokens in original coordinates (`kept_idx_orig`), which is
right for any number of pruning stages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.parallel import ratio_over_group


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of -sum(target * log_softmax(logits))."""
    return torch.mean(torch.sum(-target * F.log_softmax(logits, dim=-1), dim=-1))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with integer labels, mean over the batch."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def _kl_batchmean(log_p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.exp(log_q) * (log_q - log_p)) / log_p.shape[0]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, ...) at the (B, K) indices of its second axis."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[2]))


def backbone_loss(
    logits_s: torch.Tensor,
    tokens_s: torch.Tensor,
    logits_t: torch.Tensor,
    tokens_t: Optional[torch.Tensor],
    labels: torch.Tensor,
    kept_idx_orig: Optional[torch.Tensor] = None,
    keep_mask: Optional[torch.Tensor] = None,
    mixup_active: bool = False,
    tokens_t_probs: Optional[torch.Tensor] = None,
    tokens_t_entropy: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, dict]:
    """Classification + distillation loss.

    logits_s, tokens_s: the student's logits (B, C) and final spatial tokens
      (B, K, D), post-norm; logits_t, tokens_t: the teacher's logits and
      all its tokens (B, N, D);
    labels: (B,) integer labels, or (B, C) soft targets with mixup_active;
    kept_idx_orig: (B, K) the student's kept tokens in original coordinates,
      which pick the teacher tokens the student's align with;
    keep_mask: (B, N) threshold mode's keep mask: the token KL is the mean
      over kept tokens;
    tokens_t_probs, tokens_t_entropy: the teacher cache's form of the
      tokens, q = softmax(tokens_t) (B, N, D) and sum(q log q) (B, N); the
      token KL is then entropy - sum(q * log_softmax(tokens_s)), the same
      value. tokens_t may then be None;
    group: the data group of a DDP step, over which the threshold mode's
      kept-token count is summed (`parallel.ratio_over_group`); the other
      terms are means over the samples.
    Returns (loss, metrics).
    """
    logits_s = logits_s.float()
    logits_t = logits_t.float()
    if mixup_active:
        cls_loss = soft_target_cross_entropy(logits_s, labels)
    else:
        cls_loss = cross_entropy(logits_s, labels)
    cls_kl = _kl_batchmean(F.log_softmax(logits_s, dim=-1), F.log_softmax(logits_t, dim=-1))

    ls = F.log_softmax(tokens_s.float(), dim=-1)
    if tokens_t_probs is not None:
        q = tokens_t_probs.float()
        h = tokens_t_entropy.float()
        if kept_idx_orig is not None:
            q, h = _rows(q, kept_idx_orig), _rows(h, kept_idx_orig)
        per_token = h - torch.sum(q * ls, dim=-1)
    else:
        lt = F.log_softmax(tokens_t.float(), dim=-1)
        if kept_idx_orig is not None:
            lt = _rows(lt, kept_idx_orig)
        per_token = torch.sum(torch.exp(lt) * (lt - ls), dim=-1)
    if kept_idx_orig is None and keep_mask is not None:
        # the kept-token count couples the batch: summed over the data group,
        # a rank's term is world * sum_r / count_global, whose mean over the
        # ranks (DDP averages their gradients) is the global batch's mean
        token_kl = ratio_over_group(torch.sum(per_token * keep_mask), torch.sum(keep_mask),
                                    group)
    else:
        # the reference flattens (B*K, D) and takes batchmean: the mean
        token_kl = torch.mean(per_token)

    loss = cls_loss + cls_kl + token_kl
    metrics = {
        "backbone_loss": loss,
        "cls_loss": cls_loss,
        "cls_kl_loss": cls_kl,
        "token_kl_loss": token_kl,
    }
    return loss, metrics
