"""Megatron tensor parallelism over the mesh's 'model' group (port of
`dense2sparse_vit_tpu/parallel/tensor_parallel.py`).

Each block's matrices are split over the ranks of the model group; the
activations outside them stay whole on every rank:

  attn.qkv   (3C, C)  column parallel: rows of the torch weight (dim 0),
                      each rank's heads' rows of q, of k and of v
  attn.proj  (C, C)   row parallel: columns (dim 1), the same heads
  mlp.fc1    (4C, C)  column parallel: rows, contiguous
  mlp.fc2    (C, 4C)  row parallel: columns, contiguous
  the biases of column-parallel layers follow their rows; everything else
  (embeddings, norms, the row-parallel biases, heads, predictors) is
  replicated.

This is the JAX table (kernel (in, out): P(None, 'model') for a column
split) in the torch layout (weight (out, in): dim 0). JAX splits qkv's 3C
columns contiguously and GSPMD re-lays the result out for the head
reshape; a hand-written split must take each rank's heads instead, or the
reshape to heads would mix q with k. Around the split layers sit the
Megatron pair: f (identity forward, all-reduce backward) before a column
layer, g (all-reduce forward, identity backward) after a row layer, whose
bias is added once, after g.

The JAX package's tensor-parallel runs use the unfused block; so does this
one: `parallelize` gives a model's plain `nn.layers.Block`s the split
layers, and refuses the whole-block kernels, which cannot hold the
all-reduces after proj and fc2.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.mesh import Mesh
from dense2sparse_vit_torch.nn.layers import Attention, Block, Linear, compute_weights, dropout
from dense2sparse_vit_torch.ops.block import attention_reference

Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()


def _role(name: str) -> Optional[str]:
    """'column', 'row' or None for a state-dict name."""
    parts = name.lower().split(".")
    if "blocks" not in parts or len(parts) < 3:
        return None
    layer = parts[-2]
    if layer in ("qkv", "fc1"):
        return "column"
    if layer == "fc2" or (layer == "proj" and parts[-3] == "attn"):
        return "row"
    return None


def param_partition_spec(name: str, tensor: torch.Tensor) -> Spec:
    """The split of one parameter by its state-dict name: ('model', None)
    for a column-parallel weight, ('model',) for its bias, (None, 'model')
    for a row-parallel weight, () for a replicated one."""
    role = _role(name)
    if role == "column" and tensor.dim() == 2:
        return ("model", None)
    if role == "column" and tensor.dim() == 1 and name.endswith("bias"):
        return ("model",)
    if role == "row" and tensor.dim() == 2:
        return (None, "model")
    return REPLICATED


def _is_qkv(name: str) -> bool:
    return name.split(".")[-2] == "qkv"


def _split_qkv(t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """q, k and v each split by heads: this rank's rows of all three."""
    return torch.cat([p.chunk(size, 0)[rank] for p in t.chunk(3, 0)], 0).contiguous()


def _shard(name: str, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    spec = param_partition_spec(name, t)
    if spec == REPLICATED:
        return t
    if _is_qkv(name):
        return _split_qkv(t, rank, size)
    return t.chunk(size, spec.index("model"))[rank].contiguous()


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """This rank's part of a full state dict (`param_partition_spec`); the
    replicated entries as they are. With model = 1, the state itself."""
    size, rank = mesh.shape["model"], mesh.model_rank
    return {k: _shard(k, v, rank, size) if size > 1 else v for k, v in state.items()}


def gather_params(local: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """The full state dict from every model rank's part (every rank of the
    model group calls it; each gets the whole): the inverse of
    `shard_params`, bit for bit."""
    size = mesh.shape["model"]
    if size == 1:
        return dict(local)
    out = {}
    for k, v in local.items():
        spec = param_partition_spec(k, v)
        if spec == REPLICATED:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(size)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
        if _is_qkv(k):
            thirds = [p.chunk(3, 0) for p in parts]
            out[k] = torch.cat([torch.cat([t[j] for t in thirds], 0) for j in range(3)], 0)
        else:
            out[k] = torch.cat(parts, spec.index("model"))
    return out


def replicate(state: Mapping[str, torch.Tensor], src: int = 0) -> dict:
    """Every rank's copy of rank `src`'s tensors (a broadcast of each; with
    one process, the state as it is)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return dict(state)
    out = {}
    for k, v in state.items():
        v = v.detach().clone().contiguous()
        dist.broadcast(v, src)
        out[k] = v
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    model group backward (each rank's column slice gives part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial products summed over the model group
    forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    """(B, H_local, ...) per rank -> (B, H, ...), heads in rank order; the
    gradient is this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.h = rank, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.h:(ctx.rank + 1) * ctx.h], None, None


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> dict:
    """The parameters of a Linear from tensors (copied; no random init)."""
    return {"weight": nn.Parameter(weight.detach().clone().contiguous()),
            "bias": None if bias is None else nn.Parameter(bias.detach().clone().contiguous())}


class ColumnParallelLinear(Linear):
    """This rank's rows of a Linear (and of its bias), its input through f."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight.shape
        for k, v in _linear(weight, bias).items():
            self.register_parameter(k, v)
        self.group = group

    def forward(self, x):
        return super().forward(_CopyToModel.apply(x, self.group))


class RowParallelLinear(Linear):
    """This rank's columns of a Linear: the partial product summed over the
    model group by g, then the whole (replicated) bias."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group):
        nn.Module.__init__(self)
        self.out_features, self.in_features = weight.shape
        for k, v in _linear(weight, bias).items():
            self.register_parameter(k, v)
        self.group = group

    def forward(self, x):
        w = compute_weights(self, x.dtype)
        return _ReduceFromModel.apply(F.linear(x, w["weight"]), self.group) + w["bias"]


class TensorParallelAttention(Attention):
    """`nn.layers.Attention` on this rank's heads (the plain core); its CLS
    rows, where asked for, gathered over the model group."""

    def __init__(self, attn: Attention, mesh: Mesh):
        nn.Module.__init__(self)
        size, rank, group = mesh.shape["model"], mesh.model_rank, mesh.model_group
        if attn.num_heads % size:
            raise ValueError(f"{attn.num_heads} heads do not split over {size} model ranks")
        self.num_heads = attn.num_heads // size
        self.scale = attn.scale
        self.use_fused = False
        self.group, self.rank = group, rank
        b = attn.qkv.bias
        self.qkv = ColumnParallelLinear(_split_qkv(attn.qkv.weight, rank, size),
                                        None if b is None else _split_qkv(b, rank, size), group)
        self.proj = RowParallelLinear(attn.proj.weight.chunk(size, 1)[rank], attn.proj.bias,
                                      group)

    def forward(self, x, policy=None, *, return_cls_attn: bool = False,
                attn_drop: float = 0.0, proj_drop: float = 0.0, generator=None):
        if attn_drop > 0.0:
            raise NotImplementedError("tensor parallelism with attention dropout")
        out = attention_reference(self.qkv(x), self.num_heads, self.scale, policy=policy,
                                  return_cls=return_cls_attn)
        if return_cls_attn:
            y = dropout(self.proj(out[0]), proj_drop, generator)
            return y, _GatherHeads.apply(out[1], self.group, self.rank)
        return dropout(self.proj(out), proj_drop, generator)


def parallelize(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split every `nn.layers.Block` of `model` over the mesh's model group,
    in place (`TensorParallelAttention`, and the MLP's fc1 / fc2 as column /
    row layers), from the model's full weights; returns the model. Its
    state_dict then holds this rank's parts under the full model's names
    (`gather_params` / `shard_params` convert). With model = 1, the model
    as it is. Raises NotImplementedError for fused blocks (the whole-block
    kernels cannot hold the all-reduce after proj and fc2) and for MLP
    dropout (its masks would be drawn per shard)."""
    size = mesh.shape["model"]
    if size == 1:
        return model
    blocks = [m for m in model.modules() if isinstance(m, Block)]
    for blk in blocks:
        if blk.use_fused:
            raise NotImplementedError(
                "tensor parallelism with use_fused_attention: the whole-block kernels "
                "cannot hold the all-reduce after proj and after fc2; use the plain block")
        if blk.drop > 0.0:
            raise NotImplementedError("tensor parallelism with MLP dropout")
    group, rank = mesh.model_group, mesh.model_rank
    for blk in blocks:
        blk.attn = TensorParallelAttention(blk.attn, mesh)
        fc1, fc2 = blk.mlp.fc1, blk.mlp.fc2
        blk.mlp.fc1 = ColumnParallelLinear(fc1.weight.chunk(size, 0)[rank],
                                           fc1.bias.chunk(size, 0)[rank], group)
        blk.mlp.fc2 = RowParallelLinear(fc2.weight.chunk(size, 1)[rank], fc2.bias, group)
    return model
