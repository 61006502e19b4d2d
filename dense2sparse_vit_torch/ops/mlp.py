"""The MLP half-block with its residual, both directions.

The port of `dense2sparse_vit_tpu/ops/pallas/mlp.py`:

    out = x + fc2(GELU(fc1(LN x)))

- `fused_mlp_residual`: the forward as an autograd Function
  (`fused_mlp_residual`, a custom VJP in the JAX package), whose backward is
- `fused_mlp_residual_backward`: dx and the six parameter gradients from x
  and the output's cotangent, recomputing the forward
  (`fused_mlp_residual_backward`).

For CUDA tensors they launch `csrc/block.cu`'s d2s_mlp_residual_forward and
`csrc/block_bwd.cu`'s d2s_mlp_residual_backward (the MLP halves of the block
kernels); for CPU tensors they run `mlp_residual_reference` and autograd
through it, the plain versions. The TPU kernel's LayerNorm folded into fc1
and its 16-token padding are TPU layout choices and are not carried over.
Weights are in the torch Linear layout (out, in): w1 (hidden, C), w2 (C,
hidden), in x's dtype; the LayerNorm parameters and biases fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda, rowpad
from dense2sparse_vit_torch.ops.block import layer_norm, linear
from dense2sparse_vit_torch.ops.norm import check_ln_width

MLP_WEIGHT_KEYS = ("ln_w", "ln_b", "w1", "b1", "w2", "b2")


def mlp_residual_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    """x + fc2(GELU(fc1(LN x))) in x.dtype: the LayerNorm's statistics, the
    GELU and each product's rounding as `transformer_block_reference`'s MLP
    half (the JAX package's `_reference_mlp_residual`)."""
    hid = F.gelu(linear(layer_norm(x, ln_w, ln_b, eps), w1, b1).float()).to(x.dtype)
    return x + linear(hid, w2, b2)


def mlp_residual_backward_reference(x, g, ln_w, ln_b, w1, b1, w2, eps):
    """Plain torch version of `fused_mlp_residual_backward`: autograd through
    `mlp_residual_reference`. Returns (dx in x.dtype, d_ln_w, d_ln_b, dw1,
    db1, dw2, db2 in fp32)."""
    with torch.enable_grad():
        xs, *ws = (t.detach().clone().requires_grad_() for t in (x, ln_w, ln_b, w1, b1, w2))
        b2 = torch.zeros(w2.shape[0], device=x.device, requires_grad=True)  # db2 = sum g
        out = mlp_residual_reference(xs, *ws, b2, eps)
        dx, *dws = torch.autograd.grad(out, [xs, *ws, b2], g)
    return (dx, *(d.float() for d in dws))


def _kernel_ptrs(x, weights, what, *, backward=False):
    """Checks for the kernels at the widths they take (`ops.rowpad`'s,
    where the caller's rows were padded; the backward's LayerNorm width too,
    with `backward`); returns (M, C, hidden, the weight pointers in
    MLP_WEIGHT_KEYS order, skipping the absent b2)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}: need a CUDA or CPU tensor")
    B, N, C = x.shape
    hidden = weights["w1"].shape[0]
    if backward:
        check_ln_width(C, what)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    shapes = {"ln_w": (f32, (C,)), "ln_b": (f32, (C,)), "w1": (bf16, (hidden, C)),
              "b1": (f32, (hidden,)), "w2": (bf16, (C, hidden)), "b2": (f32, (C,))}
    ptrs = [_cuda.ptr(weights[k], k, dev, *shapes[k]) for k in MLP_WEIGHT_KEYS if k in weights]
    return B * N, C, hidden, ptrs


def _layout(x, w1):
    """`ops.rowpad`'s layout for rows of C and hidden columns that are no
    multiples of 8 (the MLP half has no heads), else None."""
    return rowpad.block_layout(x.shape[2], 1, w1.shape[0])


def _launch_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps):
    what = "fused_mlp_residual"
    w = dict(zip(MLP_WEIGHT_KEYS, (ln_w, ln_b, w1, b1, w2, b2)))
    L = _layout(x, w1)
    if L is not None:  # rows padded (ops.rowpad)
        out = rowpad.count(what, _kernel_forward(rowpad.pad(x, L, "C"),
                                                 rowpad.pad_weights(w, L), eps, L.C))
        return rowpad.unpad(out, L, "C")
    return _kernel_forward(x, w, eps, x.shape[2])


def _kernel_forward(x, w, eps, ln_c):
    what = "fused_mlp_residual"
    M, C, hidden, ptrs = _kernel_ptrs(x, w, what)
    dev = x.device
    x_ptr = _cuda.ptr(x, "x", dev, torch.bfloat16, tuple(x.shape))
    out = torch.empty_like(x)
    hid = torch.empty((M, hidden), dtype=x.dtype, device=dev)
    stats = torch.empty((M, 2), dtype=torch.float32, device=dev)
    err = _cuda.library().d2s_mlp_residual_forward(
        x_ptr, out.data_ptr(), hid.data_ptr(), stats.data_ptr(), *ptrs, M, C, hidden, ln_c,
        float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_mlp_residual_forward")
    fused_mlp_residual.launches += 1
    return out


def fused_mlp_residual_backward(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                ln_b: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                                w2: torch.Tensor, *, eps: float = 1e-6):
    """All seven cotangents of `fused_mlp_residual` from its input x and
    the cotangent g of its output: (dx in x.dtype, d_ln_w, d_ln_b, dw1, db1,
    dw2, db2), the gradients fp32 and summed over the batch in a fixed
    order. Launches count in `launches`."""
    if x.device.type == "cpu":
        return mlp_residual_backward_reference(x, g, ln_w, ln_b, w1, b1, w2, eps)
    what = "fused_mlp_residual_backward"
    w = dict(zip(MLP_WEIGHT_KEYS, (ln_w, ln_b, w1, b1, w2)))
    L = _layout(x, w1)
    if L is not None:  # rows padded (ops.rowpad)
        dx, *grads = rowpad.count(what, _kernel_backward(
            rowpad.pad(x, L, "C"), rowpad.pad(g, L, "C"), rowpad.pad_weights(w, L), eps, L.C))
        dw = rowpad.unpad_weights(dict(zip(MLP_WEIGHT_KEYS, grads)), L)
        return (rowpad.unpad(dx, L, "C"), *(dw[k] for k in MLP_WEIGHT_KEYS))
    return _kernel_backward(x, g, w, eps, x.shape[2])


def _kernel_backward(x, g, w, eps, ln_c):
    what = "fused_mlp_residual_backward"
    M, C, hidden, ptrs = _kernel_ptrs(x, w, what, backward=True)
    dev, f32 = x.device, torch.float32
    x_ptr = _cuda.ptr(x, "x", dev, torch.bfloat16, tuple(x.shape))
    g_ptr = _cuda.ptr(g, "g", dev, torch.bfloat16, tuple(x.shape))
    lib = _cuda.library()
    nbytes = lib.d2s_mlp_residual_backward_scratch_bytes(M, C, hidden)
    if nbytes <= 0:
        raise ValueError(f"{what}: M={M}, C={C}, hidden={hidden}: not taken by the kernel")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    grads = [torch.empty(w[k].shape, dtype=f32, device=dev) for k in MLP_WEIGHT_KEYS[:5]]
    grads.append(torch.empty((C,), dtype=f32, device=dev))  # db2
    err = lib.d2s_mlp_residual_backward(
        x_ptr, g_ptr, dx.data_ptr(), *ptrs, *(d.data_ptr() for d in grads), scratch.data_ptr(),
        M, C, hidden, ln_c, float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_mlp_residual_backward")
    fused_mlp_residual_backward.launches += 1
    return (dx, *grads)


class _MlpResidual(torch.autograd.Function):
    """Forward on the kernel (or the plain version), backward
    `fused_mlp_residual_backward`, which recomputes the forward from x: only
    x and the weights are kept. Gradients come back in each input's dtype,
    as the JAX package's custom VJP casts them."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        if x.device.type == "cpu":
            return mlp_residual_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps)
        return _launch_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        x, *w = ctx.saved_tensors
        grads = fused_mlp_residual_backward(x, g.contiguous(), *w[:5], eps=ctx.eps)
        return (*(d.to(t.dtype) for d, t in zip(grads, [x] + w)), None)


def fused_mlp_residual(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(GELU(fc1(LN x))), (B, N, C) -> (B, N, C), with a gradient for
    x and every weight. Launches count in `launches`."""
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    return _MlpResidual.apply(x, ln_w, ln_b, w1, b1, w2, b2, float(eps))


fused_mlp_residual.launches = 0
fused_mlp_residual_backward.launches = 0
