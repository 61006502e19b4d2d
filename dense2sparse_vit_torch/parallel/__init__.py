"""Collectives over a process group (port of
`dense2sparse_vit_tpu/parallel/__init__.py`), with the mesh helpers of
`core/mesh.py` re-exported.

Under GSPMD the JAX package's metrics and batch statistics are global by
construction. Under DDP each rank computes on its own shard and only the
gradients are averaged, so what couples the samples of a batch is made
global here: the metrics (`all_reduce_mean`), the BatchNorm predictor's
moments (`all_reduce_sum`, differentiable) and the losses' mask-count
denominators (`ratio_over_group`). A group of None stands for one rank:
every helper is then the identity.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from dense2sparse_vit_torch.core.mesh import (  # noqa: F401
    Mesh,
    barrier,
    host_local_batch,
    is_primary,
    local_rows,
    make_mesh,
    maybe_initialize_distributed,
    process_local_indices,
    world_size,
)


def group_size(group) -> int:
    """The number of ranks in `group`; 1 for None."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def all_reduce_sums(tree: Mapping[str, torch.Tensor], group=None) -> dict:
    """Each tensor of `tree` summed over the group's ranks, in fp32, by one
    all-reduce of their concatenation (every rank passes the same keys)."""
    if group_size(group) == 1:
        return dict(tree)
    keys = list(tree)
    parts = [torch.as_tensor(tree[k]).detach().float() for k in keys]
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    out, at = {}, 0
    for k, p in zip(keys, parts):
        out[k] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


def all_reduce_mean(tree: Mapping[str, torch.Tensor], group=None) -> dict:
    """Each tensor of `tree` averaged over the group's ranks, in fp32 (the
    reference's dist.reduce(SUM) and divide)."""
    n = group_size(group)
    return {k: v / n for k, v in all_reduce_sums(tree, group).items()} if n > 1 else dict(tree)


def global_batch_metrics(metrics: Mapping[str, torch.Tensor], group=None) -> dict:
    """A step's metrics over the global batch: each rank's means (over equal
    local batches) averaged over the data group. The JAX function is the
    identity, its metrics being global already."""
    return all_reduce_mean(metrics, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group both ways: the gradient of a sum every rank reads
    is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the group, differentiable: with DDP's averaged
    gradients, a term computed from the sum gets the gradient it has on the
    global batch."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def ratio_over_group(num: torch.Tensor, den: torch.Tensor, group=None) -> torch.Tensor:
    """num / den with the count `den` (a mask sum, no gradient) summed over
    the group and at least 1. DDP averages the ranks' gradients, so a rank's
    term is world * num_r / den_global: their mean is the global batch's
    sum(num) / sum(den), value and gradient. One rank: num / max(den, 1)."""
    n = group_size(group)
    if n == 1:
        return num / den.clamp_min(1.0)
    den = den.detach().clone()
    dist.all_reduce(den, group=group)
    return n * num / den.clamp_min(1.0)
