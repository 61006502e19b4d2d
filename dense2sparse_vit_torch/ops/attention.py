"""Multi-head attention on packed qkv, both directions.

The port of the packed entry points of
`dense2sparse_vit_tpu/ops/pallas/attention.py`, the attention core of a
training block that captures its CLS rows (its qkv and proj products run
outside, as torch calls, as flax Dense layers do in the JAX package):

- `fused_attention_packed`: (B, N, 3C) qkv -> (B, N, C) with an exact fp32
  row-max softmax (with a (B, N) keep policy, the policy softmax with eps/N
  smoothing), and with `return_cls` the (B, H, N) CLS (query 0) row of the
  probabilities (`fused_attention_packed`, exact=True);
- `fused_attention_backward_packed`: dqkv from qkv and the output's
  cotangent, with the CLS rows' cotangent `gcls` folded in, and dPolicy in
  policy mode (`fused_attention_backward_packed`);
- `fused_attention_packed_trainable`, `fused_attention_packed_with_cls_trainable`:
  the two as an autograd Function (the JAX package's custom VJPs).

For CUDA tensors the wrappers launch `csrc/block.cu`'s
d2s_attention_packed_forward and `csrc/block_bwd.cu`'s
d2s_attention_packed_backward, which recomputes the forward from qkv (as the
TPU kernel recomputes P), so the Function keeps only qkv and the policy
between the two. For CPU tensors they run `attention_reference` and autograd
through it, the plain versions. The kernels take head_dim 64, N <= 800
forward and N <= 384 (policy mode 352) backward.
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.ops import _cuda
from dense2sparse_vit_torch.ops.block import (
    BWD_MAX_TOKENS,
    BWD_POLICY_MAX_TOKENS,
    HEAD_DIM,
    MAX_TOKENS,
    _policy_arg,
    attention_reference,
)


def attention_backward_reference(qkv, g, num_heads, scale, *, policy=None, gcls=None,
                                 eps=1e-6, policy_grad=True):
    """Plain torch version of `fused_attention_backward_packed`: autograd
    through `attention_reference`, with `gcls` the cotangent of its CLS rows.
    Returns (dqkv in qkv.dtype, dPolicy in fp32 or None): dPolicy only with
    a policy and `policy_grad`. The policy enters in fp32, as the kernel
    takes it."""
    with torch.enable_grad():
        q = qkv.detach().clone().requires_grad_()
        pol = None
        kw = {}
        if policy is not None:
            pol = policy.detach().float().clone().requires_grad_(policy_grad)
            kw = {"policy": pol, "eps": eps}
        if gcls is None:
            outs, cots = [attention_reference(q, num_heads, scale, **kw)], [g]
        else:
            out, cls = attention_reference(q, num_heads, scale, return_cls=True, **kw)
            outs, cots = [out, cls], [g, gcls.to(cls.dtype)]
        inputs = [q] + ([pol] if pol is not None and policy_grad else [])
        grads = torch.autograd.grad(outs, inputs, cots)
    return grads[0], (grads[1] if len(grads) > 1 else None)


def _qkv_arg(qkv, num_heads, max_tokens, what):
    """Checks for the kernels; returns (B, N, C, sample stride, row stride)
    of qkv, which may be a strided view with contiguous channels."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: qkv is on {qkv.device}: need a CUDA or CPU tensor")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what}: qkv has dtype {qkv.dtype}, the kernel takes bfloat16")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 != 3 * HEAD_DIM * num_heads:
        raise ValueError(f"{what}: the kernel takes head_dim {HEAD_DIM}, got {C3} / (3 * "
                         f"{num_heads})")
    if N > max_tokens:
        raise ValueError(f"{what}: the kernel takes at most {max_tokens} tokens, got {N}")
    sb, sn, sc = qkv.stride()
    if sc != 1 or sn < C3 or sn % 8 or sb % 8 or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv needs contiguous channels, row and sample strides "
                         f"that are multiples of 8 and 16-byte alignment; got strides "
                         f"{qkv.stride()}")
    return B, N, C, sb, sn


def _default_scale(qkv, num_heads, scale):
    if qkv.dim() != 3:
        raise ValueError(f"expected qkv (B, N, 3C), got {tuple(qkv.shape)}")
    return (qkv.shape[2] // 3 // num_heads) ** -0.5 if scale is None else scale


def fused_attention_packed(qkv: torch.Tensor, num_heads: int, policy: torch.Tensor | None = None,
                           *, scale: float | None = None, eps: float = 1e-6,
                           return_cls: bool = False):
    """(B, N, 3C) packed [q | k | v] -> (B, N, C) in qkv.dtype, or (out,
    cls) with `return_cls`, cls the (B, H, N) CLS row of every head's
    probabilities (in policy mode (e_0j + eps/N) / den_0). A (B, N) keep
    `policy` selects the policy softmax with smoothing `eps`. Not
    differentiable: the trainable wrappers are. Launches count in
    `launches`."""
    scale = _default_scale(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        kw = {} if policy is None else {"policy": policy, "eps": eps}
        return attention_reference(qkv, num_heads, scale, return_cls=return_cls, **kw)
    what = "fused_attention_packed"
    B, N, C, sb, sn = _qkv_arg(qkv, num_heads, MAX_TOKENS, what)
    dev = qkv.device
    pol = _policy_arg(policy, qkv, what)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    cls = torch.empty((B, num_heads, N), dtype=qkv.dtype, device=dev) if return_cls else None
    err = _cuda.library().d2s_attention_packed_forward(
        qkv.data_ptr(), sb, sn, out.data_ptr(), 0 if cls is None else cls.data_ptr(),
        _cuda.ptr(pol, "policy", dev, torch.float32, (B, N)), B, N, num_heads, float(scale),
        float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_packed_forward")
    fused_attention_packed.launches += 1
    return (out, cls) if return_cls else out


def fused_attention_backward_packed(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, *,
                                    policy: torch.Tensor | None = None,
                                    gcls: torch.Tensor | None = None,
                                    scale: float | None = None, eps: float = 1e-6,
                                    policy_grad: bool = True):
    """dL/dqkv (B, N, 3C) in qkv.dtype from qkv and g (B, N, C), the
    cotangent of the output; with `gcls`, the (B, H, N) cotangent of the CLS
    rows, folded into the probabilities' row 0. With a policy returns
    (dqkv, dPolicy), dPolicy the (B, N) fp32 gradient of the keep policy
    (None with `policy_grad=False`, which spares the kernel its work).
    Launches count in `launches`."""
    scale = _default_scale(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        dqkv, dpol = attention_backward_reference(qkv, g, num_heads, scale, policy=policy,
                                                  gcls=gcls, eps=eps, policy_grad=policy_grad)
        return dqkv if policy is None else (dqkv, dpol)
    what = "fused_attention_backward_packed"
    max_n = BWD_MAX_TOKENS if policy is None else BWD_POLICY_MAX_TOKENS
    B, N, C, sb, sn = _qkv_arg(qkv, num_heads, max_n, what)
    dev, f32 = qkv.device, torch.float32
    pol = _policy_arg(policy, qkv, what)
    g_ptr = _cuda.ptr(g, "g", dev, torch.bfloat16, (B, N, C))
    gc = None if gcls is None else gcls.detach().float().contiguous()
    want_dpol = pol is not None and policy_grad
    dqkv = torch.empty((B, N, 3 * C), dtype=qkv.dtype, device=dev)
    o = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    stats = torch.empty((B, num_heads, N, 1 if pol is None else 4), dtype=f32, device=dev)
    dpol = torch.empty((B, N), dtype=f32, device=dev) if want_dpol else None
    part = torch.empty((B, num_heads, N), dtype=f32, device=dev) if want_dpol else None
    err = _cuda.library().d2s_attention_packed_backward(
        qkv.data_ptr(), sb, sn, g_ptr, _cuda.ptr(gc, "gcls", dev, f32, (B, num_heads, N)),
        _cuda.ptr(pol, "policy", dev, f32, (B, N)), dqkv.data_ptr(),
        0 if dpol is None else dpol.data_ptr(), o.data_ptr(), stats.data_ptr(),
        0 if part is None else part.data_ptr(), B, N, num_heads, float(scale), float(eps),
        _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_packed_backward")
    fused_attention_backward_packed.launches += 1
    return dqkv if policy is None else (dqkv, dpol)


class _PackedAttention(torch.autograd.Function):
    """Forward `fused_attention_packed`, backward
    `fused_attention_backward_packed`; only qkv and the policy are kept. An
    output that gets no gradient arrives as None: the CLS rows of a block
    whose rows feed no loss then cost the backward nothing. dPolicy is asked
    of the kernel only where the policy needs a gradient, and comes back in
    the policy's dtype."""

    @staticmethod
    def forward(ctx, qkv, policy, num_heads, scale, eps, return_cls):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(qkv, policy)
        ctx.args = (num_heads, scale, eps)
        return fused_attention_packed(qkv, num_heads, policy, scale=scale, eps=eps,
                                      return_cls=return_cls)

    @staticmethod
    def backward(ctx, g, gcls=None):
        qkv, policy = ctx.saved_tensors
        num_heads, scale, eps = ctx.args
        if g is None:
            B, N, C3 = qkv.shape
            g = qkv.new_zeros((B, N, C3 // 3))
        policy_grad = policy is not None and ctx.needs_input_grad[1]
        res = fused_attention_backward_packed(qkv, g.contiguous(), num_heads, policy=policy,
                                              gcls=gcls, scale=scale, eps=eps,
                                              policy_grad=policy_grad)
        dqkv, dpol = res if policy is not None else (res, None)
        if dpol is not None:
            dpol = dpol.to(policy.dtype).reshape(policy.shape)
        return dqkv, dpol, None, None, None, None


def fused_attention_packed_trainable(qkv: torch.Tensor, num_heads: int,
                                     policy: torch.Tensor | None = None,
                                     scale: float | None = None, eps: float = 1e-6):
    """`fused_attention_packed` with a gradient for qkv and, in policy mode,
    the policy."""
    return _PackedAttention.apply(qkv, policy, num_heads,
                                  float(_default_scale(qkv, num_heads, scale)), float(eps), False)


def fused_attention_packed_with_cls_trainable(qkv: torch.Tensor, num_heads: int,
                                              policy: torch.Tensor | None = None,
                                              scale: float | None = None, eps: float = 1e-6):
    """The same with the (B, H, N) CLS rows as a second output, whose
    cotangent the backward folds in."""
    return _PackedAttention.apply(qkv, policy, num_heads,
                                  float(_default_scale(qkv, num_heads, scale)), float(eps), True)


fused_attention_packed.launches = 0
fused_attention_backward_packed.launches = 0
