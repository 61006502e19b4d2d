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
through it, the plain versions. The kernels take every head width from 1
to 256, odd or even (`ops.block.head_width`: 64 on the wgmma cores, the
others on csrc/attention_hd.cuh's path, whose launches count in
`ATTENTION_HD` and `ATTENTION_HD_BWD`; at width 64 also past
`ops.block.SHORT_TOKENS` = 800 tokens) and every N up to
`ops.block.attention_max_tokens` both ways.

The attention half-block, x + proj(MHA(qkv(LN1 x))), the port of
`fused_attention_block` and its backward kernels in the same JAX module:

- `fused_attention_block`: the forward, plain or policy mode, with the CLS
  rows on request (`fused_attention_block`);
- `fused_attention_block_backward`, `fused_attention_block_backward_policy`:
  its seven cotangents, and dPolicy in policy mode, from x and the output's
  cotangent, recomputing the forward (the two JAX kernels of those names);
- `fused_attention_block_trainable`: the two as an autograd Function, with a
  gradient for the policy in policy mode (`fused_attention_block_trainable`).

Weights come in the torch Linear layout (out, in) in the compute dtype, the
LayerNorm and biases fp32; `bqkv` and `bproj` may be None. JAX's
`block_batch` and `interpret` have no counterpart, and neither has `exact`:
the port always computes the exact row-max softmax over the N real columns
(the JAX kernel's `exact=True`), never the TPU's clamped fast path. For
CUDA tensors the wrappers launch `csrc/block.cu`'s
d2s_attention_block_forward and `csrc/block_bwd.cu`'s
d2s_attention_block_backward (one entry, the policy nullable); for CPU tensors
they run `attention_block_reference` and autograd through it.

`fused_attention_variant` runs the half-block's inference forward with one of
the attention cores v1-v3 of `scripts/attn_variants.py` (`csrc/
attn_variants.cuh`), at every head width d from 1 to 127 and every N up to
`attention_max_tokens(d)` (`attention_variant_supported`);
`attention_variant_reference` is its plain version.
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.ops import _cuda, rowpad
from dense2sparse_vit_torch.ops.block import (
    _policy_arg,
    attention_max_tokens,
    attention_reference,
    check_tokens,
    head_width,
    layer_norm,
    linear,
    lse_is_float4,
    padded_forward,
)
from dense2sparse_vit_torch.ops.norm import LaunchCount, check_ln_width


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


def _qkv_arg(qkv, num_heads, what, *, policy=False, backward=False):
    """Checks for the kernels (`check_tokens` in the mode and direction
    given); returns (B, N, C, sample stride, row stride) of qkv, which may
    be a strided view with contiguous channels."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C3 % 3:
        raise ValueError(f"{what}: qkv's last dimension {C3} is no multiple of 3")
    d = head_width(C, num_heads, what)
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: qkv is on {qkv.device}: need a CUDA or CPU tensor")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what}: qkv has dtype {qkv.dtype}, the kernel takes bfloat16")
    check_tokens(N, d, what, policy=policy, backward=backward)
    sb, sn, sc = qkv.stride()
    if sc != 1 or sn < C3 or sn % 8 or sb % 8 or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv needs contiguous channels, row and sample strides "
                         f"that are multiples of 8 and 16-byte alignment; got strides "
                         f"{qkv.stride()}")
    return B, N, C, sb, sn


def _head_layout(qkv, num_heads, what):
    """`ops.rowpad`'s layout for a packed qkv whose C = 3C / 3 is no
    multiple of 8 (its rows no 16-byte multiple), else None."""
    C = qkv.shape[2] // 3
    head_width(C, num_heads, what)
    return rowpad.block_layout(C, num_heads)


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
    L = _head_layout(qkv, num_heads, what)
    if L is not None:  # heads of dp columns (ops.rowpad)
        got = rowpad.count(what, fused_attention_packed(
            rowpad.pad(qkv, L, "qkv"), num_heads, policy, scale=scale, eps=eps,
            return_cls=return_cls))
        if return_cls:
            return rowpad.unpad(got[0], L, "heads"), got[1]
        return rowpad.unpad(got, L, "heads")
    B, N, C, sb, sn = _qkv_arg(qkv, num_heads, what, policy=policy is not None)
    dev = qkv.device
    pol = _policy_arg(policy, qkv, what)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=dev)
    cls = torch.empty((B, num_heads, N), dtype=qkv.dtype, device=dev) if return_cls else None
    err = _cuda.library().d2s_attention_packed_forward(
        qkv.data_ptr(), sb, sn, out.data_ptr(), 0 if cls is None else cls.data_ptr(),
        _cuda.ptr(pol, "policy", dev, torch.float32, (B, N)), B, N, num_heads, C, float(scale),
        float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_packed_forward")
    fused_attention_packed.launches += 1
    return (out, cls) if return_cls else out


def _part(lib, which, B, N, C, num_heads, policy, dev):
    """The fp32 partials d2s_attention_packed_backward takes (which: 1
    dPolicy's, 0 a split sample-head's dK and dV), None where it needs none."""
    n = lib.d2s_attention_bwd_part_floats(which, B, N, num_heads, C, int(policy))
    return torch.empty((n,), dtype=torch.float32, device=dev) if n > 0 else None


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
    L = _head_layout(qkv, num_heads, what)
    if L is not None:  # heads of dp columns (ops.rowpad)
        got = rowpad.count(what, fused_attention_backward_packed(
            rowpad.pad(qkv, L, "qkv"), rowpad.pad(g, L, "heads"), num_heads, policy=policy,
            gcls=gcls, scale=scale, eps=eps, policy_grad=policy_grad))
        if policy is None:
            return rowpad.unpad(got, L, "qkv")
        return rowpad.unpad(got[0], L, "qkv"), got[1]
    B, N, C, sb, sn = _qkv_arg(qkv, num_heads, what, policy=policy is not None, backward=True)
    dev, f32 = qkv.device, torch.float32
    pol = _policy_arg(policy, qkv, what)
    g_ptr = _cuda.ptr(g, "g", dev, torch.bfloat16, (B, N, C))
    gc = None if gcls is None else gcls.detach().float().contiguous()
    want_dpol = pol is not None and policy_grad
    dqkv = torch.empty((B, N, 3 * C), dtype=qkv.dtype, device=dev)
    # the recomputed forward's output, then the rest of it in fp32 (normalised
    # by the bf16 probabilities its P.V took): the backward's D = rowsum(dO * O)
    # takes their sum
    o = torch.empty((2, B, N, C), dtype=qkv.dtype, device=dev)
    # the forward's row statistics: fp32 (plain mode on the width-64 core), else float4
    four = lse_is_float4(N, C // num_heads, pol is not None)
    stats = torch.empty((B, num_heads, N, 4 if four else 1), dtype=f32, device=dev)
    dpol = torch.empty((B, N), dtype=f32, device=dev) if want_dpol else None
    lib = _cuda.library()
    # dPolicy's partials, and the dK and dV partials of a sample-head split
    # over CTAs (N past 384, policy mode 352) or dQ's sum over the passes of
    # the attention_hd path
    part = _part(lib, 1, B, N, C, num_heads, pol is not None, dev) if want_dpol else None
    kv_part = _part(lib, 0, B, N, C, num_heads, pol is not None, dev)
    err = lib.d2s_attention_packed_backward(
        qkv.data_ptr(), sb, sn, g_ptr, _cuda.ptr(gc, "gcls", dev, f32, (B, num_heads, N)),
        _cuda.ptr(pol, "policy", dev, f32, (B, N)), dqkv.data_ptr(),
        0 if dpol is None else dpol.data_ptr(), o.data_ptr(), stats.data_ptr(),
        0 if part is None else part.data_ptr(), 0 if kv_part is None else kv_part.data_ptr(),
        B, N, num_heads, C, float(scale), float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_packed_backward")
    fused_attention_backward_packed.launches += 1
    return dqkv if policy is None else (dqkv, dpol)


# The attention core's backward kernel (`attention_bwd_kernel` in
# csrc/block_bwd.cu), which every backward entry with attention launches
# inside its C code: its launches, counted by the kernels' library
ATTENTION_BWD = LaunchCount(0, "d2s_attention_bwd_launches")
# and those of them on its long path (N past 384, policy mode 352: a
# sample-head split over CTAs), a part of ATTENTION_BWD's count
ATTENTION_BWD_LONG = LaunchCount(1, "d2s_attention_bwd_launches")
# The attention core at head widths other than 64 (csrc/attention_hd.cuh),
# launched inside every entry with attention in place of the width-64 cores:
# its forward (attention_hd_fwd.cuh's attention_hd_kernel, also in each
# backward's recompute) and its backward (attention_hd_bwd.cuh's
# attention_hd_bwd_kernel, one launch a backward)
ATTENTION_HD = LaunchCount(0, "d2s_attention_hd_launches")
ATTENTION_HD_BWD = LaunchCount(1, "d2s_attention_hd_launches")


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


# ---- the attention half-block ---------------------------------------------

ATTN_BLOCK_KEYS = ("ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")
VARIANTS = (1, 2, 3)  # the attention cores of `fused_attention_variant`
# the widest head the variants take: JAX's run_variant pads each head's V to
# 128 lanes with ones columns (scripts/attn_variants.py), none at d >= 128
VARIANT_MAX_HEAD_DIM = 127


def _scale_of(x, num_heads, scale):
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    return (x.shape[2] // num_heads) ** -0.5 if scale is None else scale


def _half_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, ln_eps, core, stages, ln_width=None):
    """x + proj(core(qkv(LN1 x))); core maps qkv to the attention output, or
    to (output, CLS rows); `ln_width` as `ops.block.layer_norm` takes it."""
    qkv = linear(layer_norm(x, ln_w, ln_b, ln_eps, ln_width), wqkv, bqkv)
    attn = core(qkv)
    cls = None
    if isinstance(attn, tuple):
        attn, cls = attn
    out = x + linear(attn, wproj, bproj)
    result = (out,) + (() if cls is None else (cls,))
    if stages:
        result += ({"qkv": qkv, "attn": attn},)
    return result if len(result) > 1 else out


def attention_block_reference(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, *,
                              policy=None, scale=None, eps=1e-6, ln_eps=1e-6,
                              return_cls=False, stages=False):
    """Plain torch version of `fused_attention_block` (the JAX package's
    `_ref_attention_block`): `out`, then the (B, H, N) CLS rows with
    `return_cls`, then {"qkv", "attn"} (the LN1-qkv projection and the
    attention core's output) with `stages`. The proj branch is rounded to
    x.dtype before the residual add, as `transformer_block_reference` does."""
    scale = _scale_of(x, num_heads, scale)
    kw = {} if policy is None else {"policy": policy, "eps": eps}
    return _half_block(
        x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, ln_eps,
        lambda qkv: attention_reference(qkv, num_heads, scale, return_cls=return_cls, **kw),
        stages)


def attention_block_backward_reference(x, g, ln_w, ln_b, wqkv, bqkv, wproj, num_heads, *,
                                       policy=None, scale=None, eps=1e-6, ln_eps=1e-6,
                                       policy_grad=True):
    """Plain torch version of the half-block's backward: autograd through
    `attention_block_reference`. Returns (dx in x.dtype, {key of
    ATTN_BLOCK_KEYS: fp32 gradient, None for a None bqkv}, dPolicy in fp32
    or None): dPolicy only with a policy and `policy_grad`. dbproj, the sum
    of g, does not need bproj. The inputs must not be inference tensors."""
    scale = _scale_of(x, num_heads, scale)
    with torch.enable_grad():
        xs = x.detach().clone().requires_grad_()
        ws = {k: None if v is None else v.detach().clone().requires_grad_()
              for k, v in zip(ATTN_BLOCK_KEYS[:5], (ln_w, ln_b, wqkv, bqkv, wproj))}
        ws["bproj"] = torch.zeros(x.shape[2], device=x.device, requires_grad=True)
        pol = None
        if policy is not None:
            pol = policy.detach().float().clone().requires_grad_(policy_grad)
        out = attention_block_reference(xs, *(ws[k] for k in ATTN_BLOCK_KEYS), num_heads,
                                        policy=pol, scale=scale, eps=eps, ln_eps=ln_eps)
        keys = [k for k in ATTN_BLOCK_KEYS if ws[k] is not None]
        inputs = [xs] + [ws[k] for k in keys]
        if pol is not None and policy_grad:
            inputs.append(pol)
        grads = torch.autograd.grad(out, inputs, g)
    dw = dict.fromkeys(ATTN_BLOCK_KEYS)
    dw.update({k: d.float() for k, d in zip(keys, grads[1:])})
    dpol = grads[-1] if pol is not None and policy_grad else None
    return grads[0], dw, dpol


def _half_block_ptrs(x, weights, num_heads, what, *, policy=False, backward=False):
    """Checks for the half-block kernels (`check_tokens` in the mode and
    direction given, and the backward's LayerNorm width); returns (B, N, C,
    x's pointer, the pointers of `weights` (a dict over ATTN_BLOCK_KEYS) in
    that order, their dtypes and shapes)."""
    B, N, C = x.shape
    d = head_width(C, num_heads, what)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}: need a CUDA or CPU tensor")
    check_tokens(N, d, what, policy=policy, backward=backward)
    if backward:
        check_ln_width(C, what)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    shapes = {"ln_w": (f32, (C,)), "ln_b": (f32, (C,)), "wqkv": (bf16, (3 * C, C)),
              "bqkv": (f32, (3 * C,)), "wproj": (bf16, (C, C)), "bproj": (f32, (C,))}
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    ptrs = [_cuda.ptr(weights.get(k), k, dev, *shapes[k]) for k in ATTN_BLOCK_KEYS]
    return B, N, C, x_ptr, ptrs, shapes


def _refuse_autograd(tensors, what):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is not differentiable on the card: under autograd use "
                           "fused_attention_block_trainable")


def fused_attention_block(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          wqkv: torch.Tensor, bqkv: torch.Tensor | None, wproj: torch.Tensor,
                          bproj: torch.Tensor | None, num_heads: int,
                          policy: torch.Tensor | None = None, *, scale: float | None = None,
                          eps: float = 1e-6, ln_eps: float = 1e-6, return_cls: bool = False,
                          stages: bool = False):
    """x + proj(MHA(qkv(LN1 x))), (B, N, C) -> (B, N, C) in x.dtype.

    With a (B, N) keep `policy`, the attention is the policy softmax with
    smoothing `eps`; without, the exact row-max softmax (JAX's `exact=True`,
    whatever JAX's caller asks: the port has no clamped path). With
    `return_cls`, also the (B, H, N) CLS row of every head's probabilities;
    with `stages`, then {"qkv", "attn"}, the kernel's intermediates. On the
    card it is not differentiable (`fused_attention_block_trainable` is).
    Launches count in `launches`."""
    scale = _scale_of(x, num_heads, scale)
    if x.device.type == "cpu":
        return attention_block_reference(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                         policy=policy, scale=scale, eps=eps, ln_eps=ln_eps,
                                         return_cls=return_cls, stages=stages)
    what = "fused_attention_block"
    _refuse_autograd((x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, policy), what)
    weights = dict(zip(ATTN_BLOCK_KEYS, (ln_w, ln_b, wqkv, bqkv, wproj, bproj)))
    head_width(x.shape[2], num_heads, what)
    L = rowpad.block_layout(x.shape[2], num_heads)
    if L is None:
        out, cls, st = _half_block_forward(x, weights, num_heads, policy, scale, eps, ln_eps,
                                           x.shape[2], return_cls, what)
    else:  # rows and heads padded (ops.rowpad)
        out, cls, st = rowpad.count(what, _half_block_forward(
            rowpad.pad(x, L, "C"), rowpad.pad_weights(weights, L), num_heads, policy, scale, eps,
            ln_eps, L.C, return_cls, what))
        out, st = rowpad.unpad(out, L, "C"), rowpad.unpad_stages(st, L)
    result = (out,) + (() if cls is None else (cls,))
    if stages:
        result += (st,)
    return result if len(result) > 1 else out


def _half_block_forward(x, weights, num_heads, policy, scale, eps, ln_eps, ln_c, return_cls,
                        what):
    """One d2s_attention_block_forward call at widths the kernels take:
    (out, CLS rows or None, {"qkv", "attn"})."""
    B, N, C, x_ptr, ptrs, _ = _half_block_ptrs(x, weights, num_heads, what,
                                               policy=policy is not None)
    dev = x.device
    pol = _policy_arg(policy, x, what)
    out = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=dev)
    attn = torch.empty_like(x)
    stats = torch.empty((B * N, 2), dtype=torch.float32, device=dev)
    cls = torch.empty((B, num_heads, N), dtype=x.dtype, device=dev) if return_cls else None
    err = _cuda.library().d2s_attention_block_forward(
        x_ptr, out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), stats.data_ptr(), *ptrs, 0,
        0 if cls is None else cls.data_ptr(),
        _cuda.ptr(pol, "policy", dev, torch.float32, (B, N)), B, N, C, num_heads, ln_c,
        float(scale), float(ln_eps), float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_block_forward")
    fused_attention_block.launches += 1
    return out, cls, {"qkv": qkv, "attn": attn}


def _attention_block_backward(x, g, weights, num_heads, policy, scale, eps, ln_eps,
                              policy_grad, what):
    """(dx, {key: fp32 gradient}, dPolicy) from the kernel or, for CPU
    tensors, the plain version; counted in the wrapper `what` names."""
    scale = _scale_of(x, num_heads, scale)
    w5 = [weights[k] for k in ATTN_BLOCK_KEYS[:5]]
    if x.device.type == "cpu":
        return attention_block_backward_reference(x, g, *w5, num_heads, policy=policy,
                                                  scale=scale, eps=eps, ln_eps=ln_eps,
                                                  policy_grad=policy_grad)
    head_width(x.shape[2], num_heads, what)
    L = rowpad.block_layout(x.shape[2], num_heads)
    if L is None:
        return _half_block_backward(x, g, weights, num_heads, policy, scale, eps, ln_eps,
                                    policy_grad, x.shape[2], what)
    # rows and heads padded (ops.rowpad)
    dx, dw, dpol = rowpad.count(what, _half_block_backward(
        rowpad.pad(x, L, "C"), rowpad.pad(g, L, "C"), rowpad.pad_weights(weights, L), num_heads,
        policy, scale, eps, ln_eps, policy_grad, L.C, what))
    return rowpad.unpad(dx, L, "C"), rowpad.unpad_weights(dw, L), dpol


def _half_block_backward(x, g, weights, num_heads, policy, scale, eps, ln_eps, policy_grad,
                         ln_c, what):
    """One d2s_attention_block_backward call at widths the kernels take."""
    B, N, C, x_ptr, ptrs, shapes = _half_block_ptrs(x, weights, num_heads, what,
                                                    policy=policy is not None, backward=True)
    dev, f32 = x.device, torch.float32
    g_ptr = _cuda.ptr(g, "g", dev, torch.bfloat16, (B, N, C))
    pol = _policy_arg(policy, x, what)
    lib = _cuda.library()
    nbytes = lib.d2s_attention_block_backward_scratch_bytes(B, N, C, num_heads,
                                                            int(pol is not None))
    if nbytes <= 0:
        raise ValueError(f"{what}: shapes {(B, N, C)}, {num_heads} heads: not taken by the "
                         "kernel")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dw = {k: None if k == "bqkv" and weights[k] is None
          else torch.empty(shapes[k][1], dtype=f32, device=dev) for k in ATTN_BLOCK_KEYS}
    dpol = torch.empty((B, N), dtype=f32, device=dev) if pol is not None and policy_grad else None
    err = lib.d2s_attention_block_backward(
        x_ptr, g_ptr, dx.data_ptr(), *ptrs[:5],
        *(0 if dw[k] is None else dw[k].data_ptr() for k in ATTN_BLOCK_KEYS),
        _cuda.ptr(pol, "policy", dev, f32, (B, N)), 0 if dpol is None else dpol.data_ptr(),
        scratch.data_ptr(), B, N, C, num_heads, ln_c, float(scale), float(ln_eps), float(eps),
        _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_block_backward")
    if policy is None:
        fused_attention_block_backward.launches += 1
    else:
        fused_attention_block_backward_policy.launches += 1
    return dx, dw, dpol


def fused_attention_block_backward(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                   ln_b: torch.Tensor, wqkv: torch.Tensor,
                                   bqkv: torch.Tensor | None, wproj: torch.Tensor,
                                   num_heads: int, *, scale: float | None = None,
                                   ln_eps: float = 1e-6):
    """All cotangents of the plain-mode half-block from its input x and the
    cotangent g of its output: (dx in x.dtype, d_ln_w, d_ln_b, dwqkv, dbqkv,
    dwproj, dbproj), the gradients fp32 and summed over the batch in a fixed
    order (dbqkv None where bqkv is). Launches count in `launches`."""
    w = dict(zip(ATTN_BLOCK_KEYS, (ln_w, ln_b, wqkv, bqkv, wproj, None)))
    dx, dw, _ = _attention_block_backward(x, g, w, num_heads, None, scale, 1e-6, ln_eps, False,
                                          "fused_attention_block_backward")
    return (dx, *(dw[k] for k in ATTN_BLOCK_KEYS))


def fused_attention_block_backward_policy(x: torch.Tensor, g: torch.Tensor,
                                          policy: torch.Tensor, ln_w: torch.Tensor,
                                          ln_b: torch.Tensor, wqkv: torch.Tensor,
                                          bqkv: torch.Tensor | None, wproj: torch.Tensor,
                                          num_heads: int, *, scale: float | None = None,
                                          eps: float = 1e-6, ln_eps: float = 1e-6):
    """The policy-mode half-block's cotangents: (dx, dPolicy, d_ln_w, d_ln_b,
    dwqkv, dbqkv, dwproj, dbproj), dPolicy the (B, N) fp32 gradient of the
    keep policy. Launches count in `launches`."""
    w = dict(zip(ATTN_BLOCK_KEYS, (ln_w, ln_b, wqkv, bqkv, wproj, None)))
    dx, dw, dpol = _attention_block_backward(x, g, w, num_heads, policy, scale, eps, ln_eps,
                                             True, "fused_attention_block_backward_policy")
    return (dx, dpol, *(dw[k] for k in ATTN_BLOCK_KEYS))


class _TrainableAttentionBlock(torch.autograd.Function):
    """Forward `fused_attention_block`, backward the half-block's backward
    kernel, which recomputes the forward from x: only x, the policy and the
    weights are kept. Gradients come back in each input's dtype (the JAX
    custom VJP casts them); dPolicy is asked of the kernel only where the
    policy needs a gradient."""

    @staticmethod
    def forward(ctx, x, policy, num_heads, scale, eps, ln_eps, *weights):
        ctx.save_for_backward(x, policy, *weights)
        ctx.args = (num_heads, scale, eps, ln_eps)
        return fused_attention_block(x, *weights, num_heads, policy, scale=scale, eps=eps,
                                     ln_eps=ln_eps)

    @staticmethod
    def backward(ctx, g):
        x, policy, *weights = ctx.saved_tensors
        num_heads, scale, eps, ln_eps = ctx.args
        w = dict(zip(ATTN_BLOCK_KEYS, weights))
        policy_grad = policy is not None and ctx.needs_input_grad[1]
        what = ("fused_attention_block_backward" if policy is None
                else "fused_attention_block_backward_policy")
        dx, dw, dpol = _attention_block_backward(x, g.contiguous(), w, num_heads, policy, scale,
                                                 eps, ln_eps, policy_grad, what)
        grads = [None if t is None else dw[k].to(t.dtype) for k, t in w.items()]
        if dpol is not None:
            dpol = dpol.to(policy.dtype).reshape(policy.shape)
        return (dx, dpol, None, None, None, None, *grads)


def fused_attention_block_trainable(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                                    wqkv: torch.Tensor, bqkv: torch.Tensor | None,
                                    wproj: torch.Tensor, bproj: torch.Tensor | None,
                                    num_heads: int, policy: torch.Tensor | None = None, *,
                                    scale: float | None = None, eps: float = 1e-6,
                                    ln_eps: float = 1e-6):
    """`fused_attention_block` with a gradient for x, every weight and, in
    policy mode, the policy."""
    return _TrainableAttentionBlock.apply(x, policy, num_heads,
                                          float(_scale_of(x, num_heads, scale)), float(eps),
                                          float(ln_eps), ln_w, ln_b, wqkv, bqkv, wproj, bproj)


# ---- the variants' attention cores ------------------------------------------


def paired_attention_reference(qkv, num_heads, scale):
    """v2's algebra: for each head pair (a, b), S+ = [qa|qb].[ka|kb]^T and
    S- = [qa|-qb].[ka|kb]^T in fp32, Sa = (S+ + S-) / 2, Sb = (S+ - S-) / 2,
    then each head's exact softmax; an odd last head alone."""
    B, N, C3 = qkv.shape
    q, k, v = qkv.view(B, N, 3, num_heads, C3 // 3 // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    scores = []
    for a in range(0, num_heads - 1, 2):
        kab = torch.cat([k[:, a], k[:, a + 1]], -1).float()
        s_sum = torch.cat([q[:, a], q[:, a + 1]], -1).float() @ kab.transpose(-1, -2)
        s_dif = torch.cat([q[:, a], -q[:, a + 1]], -1).float() @ kab.transpose(-1, -2)
        scores += [0.5 * (s_sum + s_dif), 0.5 * (s_sum - s_dif)]
    if num_heads % 2:
        scores.append(q[:, -1].float() @ k[:, -1].float().transpose(-1, -2))
    p = torch.softmax(torch.stack(scores, 1) * scale, dim=-1).to(qkv.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(B, N, C3 // 3)


def attention_variant_reference(variant, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads, *,
                                scale=None, ln_eps=1e-6, stages=False, ln_width=None):
    """Plain torch version of `fused_attention_variant`: the half-block whose
    attention core is v2's head-pair algebra (`paired_attention_reference`)
    for variant 2, and the exact softmax of `attention_reference` for v1 and
    v3, which differ from it in their schedule, not their algebra.
    `ln_width`: the LayerNorm's width where x's rows end in zero columns
    (`ops.block.layer_norm`; the padded route's stand-in for the kernel)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant}: expected one of {VARIANTS}")
    scale = _scale_of(x, num_heads, scale)
    core = paired_attention_reference if variant == 2 else attention_reference
    return _half_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, ln_eps,
                       lambda qkv: core(qkv, num_heads, scale), stages, ln_width)


def attention_variant_supported(variant: int, n: int, num_heads: int, d: int) -> bool:
    """Whether `fused_attention_variant` takes `variant` at n tokens and
    num_heads heads of width d on the card: d from 1 to VARIANT_MAX_HEAD_DIM
    (JAX's `run_variant` takes no wider head), n from 1 to
    `ops.block.attention_max_tokens(d)`, the half-block's forward ceiling.
    Needs no card; the C library's d2s_attention_variant_supported repeats
    it."""
    return (variant in VARIANTS and num_heads > 0 and 0 < d <= VARIANT_MAX_HEAD_DIM
            and 0 < n <= attention_max_tokens(d))


def check_variant_shape(variant: int, n: int, C: int, num_heads: int, what: str) -> int:
    """The head width d = C / num_heads where `fused_attention_variant` takes
    `variant` at n tokens; else ValueError naming the limit and its cause."""
    if variant not in VARIANTS:
        raise ValueError(f"{what}: variant {variant}: expected one of {VARIANTS}")
    d = head_width(C, num_heads, what)
    if d > VARIANT_MAX_HEAD_DIM:
        raise ValueError(
            f"{what}: head width {d} (C={C}, {num_heads} heads): the variants take 1 to "
            f"{VARIANT_MAX_HEAD_DIM}, as JAX's run_variant does: it pads each head's V with "
            "128 - d ones columns and divides by the first of them "
            "(scripts/attn_variants.py::_variant_kernel, av), none at d >= 128")
    limit = attention_max_tokens(d)
    if not 0 < n <= limit:
        raise ValueError(
            f"{what}: v{variant} at {n} tokens of head width {d}: the variants take 1 to "
            f"{limit}, fused_attention_block's forward ceiling at that width "
            "(ops.block.attention_max_tokens)")
    return d


def fused_attention_variant(variant: int, x: torch.Tensor, ln_w: torch.Tensor,
                            ln_b: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor | None,
                            wproj: torch.Tensor, bproj: torch.Tensor | None, num_heads: int, *,
                            scale: float | None = None, ln_eps: float = 1e-6,
                            stages: bool = False):
    """The half-block's inference forward (no policy, no CLS rows) with the
    attention core of `variant` in VARIANTS: 1 one pass with an online
    softmax, 2 head pairs by sum and difference, 3 two phases over all
    heads (`csrc/attn_variants.cuh`). With `stages`, (out, {"qkv", "attn"}).
    On the card it takes every head width d from 1 to VARIANT_MAX_HEAD_DIM
    at any C = H d (rows and heads padded by `ops.rowpad` where C is no
    multiple of 8; such launches count in `rowpad.PADDED`) and every N up to
    `attention_max_tokens(d)` (`attention_variant_supported`), and raises a
    ValueError past them. Not differentiable. Launches count in
    `launches`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant}: expected one of {VARIANTS}")
    scale = _scale_of(x, num_heads, scale)
    if x.device.type == "cpu":
        return attention_variant_reference(variant, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                                           num_heads, scale=scale, ln_eps=ln_eps, stages=stages)
    what = "fused_attention_variant"
    C = x.shape[2]
    check_variant_shape(variant, x.shape[1], C, num_heads, what)
    _refuse_autograd((x, ln_w, ln_b, wqkv, bqkv, wproj, bproj), what)
    weights = dict(zip(ATTN_BLOCK_KEYS, (ln_w, ln_b, wqkv, bqkv, wproj, bproj)))
    out, st, padded = variant_route(x, weights, num_heads, lambda xp, wp: _variant_forward(
        variant, xp, wp, num_heads, scale, ln_eps, C, what))
    if padded:
        rowpad.count(what)
    return (out, st) if stages else out


def variant_route(x, weights, num_heads, kernel):
    """The variants' forward at widths the kernels take: `kernel(xp, wp)` ->
    (out, {"qkv", "attn"}) on x and the weights (a dict over
    ATTN_BLOCK_KEYS) as they are, or padded by `ops.rowpad` where C is no
    multiple of its quantum, out and the stages unpadded. Returns (out,
    stages, whether it padded)."""
    L = rowpad.block_layout(x.shape[2], num_heads)
    if L is None:
        return (*kernel(x, weights), False)
    out, st, _ = padded_forward(x, weights, L, lambda xp, wp: (*kernel(xp, wp), None))
    return out, st, True


def _variant_forward(variant, x, weights, num_heads, scale, ln_eps, ln_c, what):
    """One d2s_attention_variant_forward call at widths the kernels take:
    (out, {"qkv", "attn"})."""
    B, N, C, x_ptr, ptrs, _ = _half_block_ptrs(x, weights, num_heads, what)
    dev = x.device
    lib = _cuda.library()
    nbytes = lib.d2s_attention_variant_scratch_bytes(variant, B, N, C, num_heads)
    if nbytes < 0:
        raise ValueError(f"{what}: v{variant} at shapes {(B, N, C)}, {num_heads} heads: not "
                         "taken by the kernel")
    work = torch.empty((nbytes,), dtype=torch.uint8, device=dev) if nbytes else None
    out = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=x.dtype, device=dev)
    attn = torch.empty_like(x)
    stats = torch.empty((B * N, 2), dtype=torch.float32, device=dev)
    err = lib.d2s_attention_variant_forward(
        x_ptr, out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), stats.data_ptr(), *ptrs,
        0 if work is None else work.data_ptr(), variant, B, N, C, num_heads, ln_c, float(scale),
        float(ln_eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_attention_variant_forward")
    fused_attention_variant.launches += 1
    return out, {"qkv": qkv, "attn": attn}


fused_attention_packed.launches = 0
fused_attention_backward_packed.launches = 0
fused_attention_block.launches = 0
fused_attention_block_backward.launches = 0
fused_attention_block_backward_policy.launches = 0
fused_attention_variant.launches = 0
