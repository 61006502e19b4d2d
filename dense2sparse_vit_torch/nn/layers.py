"""Core ViT layers (port of `dense2sparse_vit_tpu/nn/layers.py`).

As in the JAX package, parameters are fp32 and activations run in the dtype
of the input (the model's compute dtype): each layer multiplies by copies of
its weights in that dtype, which `compute_weights` makes once and keeps.
Images are NHWC. Module and parameter names follow the reference torch key
layout (`blocks.{i}.attn.qkv.weight`, ...), so a JAX checkpoint maps onto
them key by key (`utils/convert.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.ops.attention import (
    fused_attention_packed_trainable,
    fused_attention_packed_with_cls_trainable,
)
from dense2sparse_vit_torch.ops.block import (
    attention_reference,
    fused_transformer_block,
    fused_transformer_block_cls,
    fused_transformer_block_trainable,
    layer_norm,
)
from dense2sparse_vit_torch.ops.mlp import fused_mlp_residual
from dense2sparse_vit_torch.ops.quant import fused_transformer_block_int8, quantize_matrices


def _param_key(params) -> tuple:
    # an inference tensor has no version counter; it cannot be changed in
    # place outside inference mode
    return tuple((p.data_ptr(), -1 if p.is_inference() else p._version) for p in params)


def cached_tensors(module: nn.Module, tag: str, key, make) -> dict:
    """The tensors `make()` returns ({name: tensor}), kept on `module` as
    non-persistent buffers `_{tag}_{name}` and remade when `key()` changes.

    Buffers, so that `torch.export` lifts them into the artifact as they are
    instead of recomputing them in the graph. While export traces, the
    parameters are fake and have no data pointer to key on: the buffers of
    the last eager call are used as they stand (`utils.export` makes one
    eager call right before it traces), or, without one, `make()` runs in
    the traced graph.
    """
    caches = module.__dict__.setdefault("_weight_caches", {})
    if torch.compiler.is_compiling():
        if tag not in caches:
            return make()
        return {n: module._buffers[f"_{tag}_{n}"] for n in caches[tag][1]}
    k = key()
    if tag not in caches or caches[tag][0] != k:
        tensors = make()
        for n, t in tensors.items():
            module.register_buffer(f"_{tag}_{n}", t, persistent=False)
        caches[tag] = (k, tuple(tensors))
    return {n: module._buffers[f"_{tag}_{n}"] for n in caches[tag][1]}


def compute_weights(module: nn.Module, dtype: torch.dtype) -> dict:
    """`module`'s own parameters by name, in `dtype`.

    Outside autograd the copies are made once per dtype and kept on the
    module (`cached_tensors`); they are remade after a parameter is replaced
    or changed in place (`load_state_dict`, `.to(device)`). A parameter
    already in `dtype` is returned as it is. Under autograd the casts are
    made on each call, so that gradients reach the fp32 parameters.
    """
    params = {n: p for n, p in module._parameters.items() if p is not None}
    if torch.is_grad_enabled() and any(p.requires_grad for p in params.values()):
        return {n: p.to(dtype) for n, p in params.items()}
    cast = {n: p for n, p in params.items() if p.dtype != dtype}
    if not cast:
        return params
    copies = cached_tensors(module, str(dtype).replace("torch.", ""),
                            lambda: (dtype,) + _param_key(cast.values()),
                            lambda: {n: p.detach().to(dtype) for n, p in cast.items()})
    return {n: copies.get(n, p) for n, p in params.items()}


# std of a unit normal cut at +-2: flax's truncated_normal(0.02, -2, 2)
# scales by 0.02 / this, so that the cut distribution has std 0.02
_CUT_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """DeiT init as flax draws it: truncated normal of std 0.02, cut at two
    standard deviations of the uncut normal."""
    std = 0.02 / _CUT_STD
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Linear(nn.Linear):
    """nn.Linear computing in the dtype of its input."""

    def forward(self, x):
        w = compute_weights(self, x.dtype)
        return F.linear(x, w["weight"], w.get("bias"))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with fp32 statistics, returning the dtype of its input."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class PatchEmbed(nn.Module):
    """Image to patch embedding by a strided conv; NHWC images in."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        """(B, H, W, C_in) -> (B, H/p * W/p, embed_dim), in x's dtype."""
        w = compute_weights(self.proj, x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w["weight"], w["bias"], stride=self.patch_size)
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x).float()).to(x.dtype))


class Attention(nn.Module):
    """Multi-head self-attention, exact fp32 softmax (with a (B, N) keep
    policy, `ops.masked_softmax.softmax_with_policy`). With
    `return_cls_attn`, forward returns (out, cls_attn): the (B, H, N) CLS row
    of the attention probabilities. With `use_fused`, the core between the
    qkv and proj products is `ops.attention`'s packed attention, an autograd
    Function with a kernel both ways (the JAX Attention's fused route,
    `nn/layers.py:115-144`)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, use_fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.use_fused = use_fused
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x, policy=None, *, return_cls_attn: bool = False):
        qkv = self.qkv(x)
        if self.use_fused:
            core = (fused_attention_packed_with_cls_trainable if return_cls_attn
                    else fused_attention_packed_trainable)
            out = core(qkv, self.num_heads, policy, self.scale)
        else:
            out = attention_reference(qkv, self.num_heads, self.scale, policy=policy,
                                      return_cls=return_cls_attn)
        if return_cls_attn:
            return self.proj(out[0]), out[1]
        return self.proj(out)


def draw_branch_scales(batch: int, rate: float,
                       generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's two DropPath draws: (sa, sm), each (B,) fp32 on the
    generator's device, Bernoulli(keep)/keep per sample with keep = 1 - rate,
    the attention branch's first, then the MLP branch's (JAX
    `nn/layers.py:312-327`). Both of a Block's routes take their scales from
    here, so that one generator state gives the same draws on the kernel
    route and on the plain one."""
    keep = 1.0 - rate
    draws = torch.empty((2, batch), device=generator.device).bernoulli_(keep, generator=generator)
    return draws[0] / keep, draws[1] / keep


class DropPath(nn.Module):
    """Stochastic depth: the residual branch times a per-sample scale from
    `draw_branch_scales` (training only; the Block draws the scales)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, scale: Optional[torch.Tensor] = None):
        """x (B, ...) times the (B,) `scale`, in fp32 rounded once to
        x.dtype; x itself where there is no scale."""
        if scale is None:
            return x
        return (x.float() * scale.view((-1,) + (1,) * (x.dim() - 1))).to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer encoder block.

    With `use_fused`, the block runs kernel wrappers chosen as the JAX
    package's Block chooses, by mode and not by whether autograd is on
    (`nn/layers.py:239-392`). In eval mode the whole block is one call:
    with `return_cls_attn`, `ops.block.fused_transformer_block_cls` (the
    teacher's and an eval student's CLS capture), else
    `fused_transformer_block`. In train mode without CLS capture it is
    `fused_transformer_block_trainable`, whose backward is the
    block-backward kernel. In train mode with CLS capture (a student that
    collects its own CLS rows) it takes two halves: LN1, the `qkv` product,
    `ops.attention.fused_attention_packed_with_cls_trainable` (the packed
    attention core with its CLS rows, whose backward folds in their
    cotangent), the `proj` product and the residual, then
    `ops.mlp.fused_mlp_residual`; the products and LN1 stay torch calls, as
    flax Dense and LayerNorm layers in the JAX package. A (B, N) keep
    `policy` (threshold pruning, the gumbel baseline's training) goes to
    the same wrappers, which then run their policy mode. Each wrapper
    launches its CUDA kernel for a CUDA tensor and runs its plain torch
    version for a CPU tensor.

    Stochastic depth (drop_path > 0, train mode) draws the two branches'
    per-sample scales from the `generator` the caller passes
    (`draw_branch_scales`); it raises without one. As in the JAX Block
    (`nn/layers.py:231-245`), the fused block without CLS capture hands them
    to `fused_transformer_block_trainable`, whose kernels scale the branches
    both ways; with CLS capture the block leaves the whole-block kernel and
    the MLP half's kernel, which have no scale: LN1, the attention (its
    packed core when fused), DropPath, then the plain Mlp with DropPath.

    With quant="int8" (W8A8 serving, JAX `nn/layers.py:295-311`), the eval
    mode's policy-free block without CLS capture runs
    `ops.quant.fused_transformer_block_int8` on `int8_weights`; policy
    blocks, CLS capture and train mode keep the wrappers above.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, layer_norm_eps: float = 1e-6,
                 use_fused: bool = False, quant: str = "none"):
        super().__init__()
        if quant not in ("none", "int8") or (quant == "int8" and not use_fused):
            raise ValueError(f"quant={quant!r}: 'none', or 'int8' with use_fused")
        self.use_fused = use_fused
        self.quant = quant
        self.norm1 = LayerNorm(dim, eps=layer_norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, use_fused=use_fused)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def kernel_weights(self, dtype: torch.dtype) -> dict:
        """The block's weights in the layout `fused_transformer_block` takes."""
        qkv = compute_weights(self.attn.qkv, dtype)
        return {
            "ln1_w": self.norm1.weight, "ln1_b": self.norm1.bias,
            "wqkv": qkv["weight"], "bqkv": self.attn.qkv.bias,
            "wproj": compute_weights(self.attn.proj, dtype)["weight"],
            "bproj": self.attn.proj.bias,
            "ln2_w": self.norm2.weight, "ln2_b": self.norm2.bias,
            "w1": compute_weights(self.mlp.fc1, dtype)["weight"],
            "b1": self.mlp.fc1.bias,
            "w2": compute_weights(self.mlp.fc2, dtype)["weight"],
            "b2": self.mlp.fc2.bias,
        }

    def int8_weights(self, dtype: torch.dtype) -> dict:
        """The layout `fused_transformer_block_int8` takes: the four matrices
        quantized from their `dtype` copies (as the JAX block quantizes its
        compute-dtype casts), kept on the block until a weight changes; the
        LayerNorm parameters and biases as they are (fp32)."""
        w = self.kernel_weights(dtype)
        mats = (self.attn.qkv.weight, self.attn.proj.weight, self.mlp.fc1.weight,
                self.mlp.fc2.weight)
        codes = cached_tensors(self, f"int8_{str(dtype).replace('torch.', '')}",
                               lambda: (dtype,) + _param_key(mats), lambda: quantize_matrices(w))
        return {**{k: w[k] for k in ("ln1_w", "ln1_b", "bqkv", "bproj", "ln2_w", "ln2_b",
                                     "b1", "b2")}, **codes}

    def forward(self, x, policy=None, *, return_cls_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, N, C) -> (B, N, C); with `return_cls_attn`, (out, cls_attn)
        with the (B, H, N) CLS row of the attention probabilities. policy:
        an optional (B, N) or (B, N, 1) keep mask (1 = kept), CLS included.
        generator: the source of the DropPath draws, which train mode with
        drop_path > 0 needs."""
        if policy is not None:
            policy = policy.reshape(x.shape[0], x.shape[1])
        if (self.quant == "int8" and not self.training and policy is None
                and not return_cls_attn):
            return fused_transformer_block_int8(x, self.int8_weights(x.dtype),
                                                self.attn.num_heads, scale=self.attn.scale,
                                                ln_eps=self.norm1.eps)
        sa = sm = None
        if self.training and self.drop_path.rate > 0:
            if generator is None:
                raise ValueError("a training block with drop_path > 0 draws its DropPath "
                                 "scales: pass a torch.Generator")
            sa, sm = draw_branch_scales(x.shape[0], self.drop_path.rate, generator)
        if self.use_fused and not (return_cls_attn and sa is not None):
            if self.training and return_cls_attn:
                y, cls_attn = self.attn(self.norm1(x), policy, return_cls_attn=True)
                x = x + y
                x = fused_mlp_residual(
                    x, self.norm2.weight, self.norm2.bias,
                    compute_weights(self.mlp.fc1, x.dtype)["weight"], self.mlp.fc1.bias,
                    compute_weights(self.mlp.fc2, x.dtype)["weight"], self.mlp.fc2.bias,
                    self.norm2.eps)
                return x, cls_attn
            w = self.kernel_weights(x.dtype)
            kw = dict(scale=self.attn.scale, ln_eps=self.norm1.eps)
            if return_cls_attn:
                return fused_transformer_block_cls(x, w, self.attn.num_heads, policy, **kw)
            if self.training:
                return fused_transformer_block_trainable(
                    x, w, self.attn.num_heads, policy,
                    branch_scales=None if sa is None else (sa, sm), **kw)
            return fused_transformer_block(x, w, self.attn.num_heads, policy, **kw)
        y = self.attn(self.norm1(x), policy, return_cls_attn=return_cls_attn)
        if return_cls_attn:
            y, cls_attn = y
        x = x + self.drop_path(y, sa)
        x = x + self.drop_path(self.mlp(self.norm2(x)), sm)
        return (x, cls_attn) if return_cls_attn else x
