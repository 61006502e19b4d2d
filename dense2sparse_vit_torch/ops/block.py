"""Whole pre-norm transformer block, both directions.

The port of `dense2sparse_vit_tpu/ops/pallas/block.py`, in its plain and
its policy mode, with its DropPath branch scales:

    x_mid = x + sa[b] * proj(MHA(qkv(LN1 x)))
    out   = x_mid + sm[b] * fc2(GELU(fc1(LN2 x_mid)))

`branch_scales` = (sa, sm), two (B,) fp32 vectors of Bernoulli(keep)/keep
draws (stochastic depth, one draw per sample and branch), or None: no
scale. Each branch is scaled and added to its residual in fp32 and the sum
rounded once, as the JAX package's `_ref_block` defines; the scales are
constants and get no gradient (JAX `_ftb_bwd` returns zeros for them).

Plain mode takes an exact fp32 row-max softmax over the N real tokens, which
is what the JAX package's `_ref_block` defines. Policy mode takes a (B, N)
keep policy and the softmax of `ops.masked_softmax.softmax_with_policy`
(dropped columns zeroed except on the diagonal, eps/N smoothing), the
threshold and gumbel paths' attention.

- `fused_transformer_block`: the forward (`fused_transformer_block`);
- `fused_transformer_block_cls`: the same with the CLS row of every head's
  attention probabilities as a second output (the TPU kernel's
  `return_cls=True`), which the teacher hands to the mask loss;
- `fused_transformer_block_backward`: dx, the twelve parameter gradients
  and, in policy mode, dPolicy, from x and the output's cotangent,
  recomputing the forward (`fused_transformer_block_backward`);
- `fused_transformer_block_trainable`: the block as an autograd Function,
  forward `fused_transformer_block`, backward
  `fused_transformer_block_backward` (`fused_transformer_block_trainable`).

Every entry but the CLS one takes `branch_scales`; launches with scales
count in `scaled_launches`, whatever the mode.

For CUDA tensors the wrappers launch `csrc/block.cu` and `csrc/block_bwd.cu`;
for CPU tensors they run `transformer_block_reference` and
`transformer_block_backward_reference`, the plain torch versions. The two
forwards go through the custom ops `d2s::block_forward` and
`d2s::block_forward_cls` (a `cuda` implementation that launches the
kernel and counts the launch, a `cpu` one that runs the plain version, and
a fake one for `torch.export`); on the CPU under autograd the wrappers call
the differentiable plain version directly.

Weights are a dict with the keys of `BLOCK_WEIGHT_KEYS`: the matrices in the
torch Linear layout (out, in) and the compute dtype, the LayerNorm
parameters and biases in fp32; `bqkv` may be None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda, rowpad
from dense2sparse_vit_torch.ops.masked_softmax import softmax_with_policy
from dense2sparse_vit_torch.ops.norm import check_ln_width

BLOCK_WEIGHT_KEYS = (
    "ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj",
    "ln2_w", "ln2_b", "w1", "b1", "w2", "b2",
)
# The head widths the kernels take: every d = C / num_heads from 1 to
# MAX_HEAD_DIM, odd or even (256: wgmma's widest n, twice ViT-22B's head).
# d = HEAD_DIM runs the width-64 wgmma cores of csrc/block.cu and
# csrc/block_bwd.cu up to SHORT_TOKENS; every other width the wgmma pair of
# csrc/attention_hd.cuh (odd widths with gathered copies, widths past 128
# with one key block a backward pass), chosen by the C code from d.
HEAD_DIM = 64
MAX_HEAD_DIM = 256
# Sequence length. The d = 64 forward core keeps a sample-head's K and V in
# shared memory, SHORT_TOKENS keys at most (its backward splits a
# sample-head longer than 384 tokens, policy mode 352, over 2-3 CTAs).
# Longer d = 64 heads, like every other width, take the pair of
# csrc/attention_hd.cuh both ways, which streams keys and queries through
# rings: what grows with N in its shared memory is the rows it keeps of every
# key (forward: pol_j and the CLS row's raw scores, 4 B each) and of every
# query (backward: the row statistics, 16 B). `attention_max_tokens` is its
# ceiling, attention_hd.cuh's hd_max_tokens repeated (the library's
# d2s_attention_max_tokens): the longest N whose layout fits SMEM_BYTES with
# a ring of two, in 64-token blocks.
SHORT_TOKENS = 800
SMEM_BYTES = 232448  # the most dynamic shared memory a CTA takes on an H100
_BLK = 64  # the rows of a query or key block on that path
_NARROW = 128  # the widest padded head whose backward takes two key blocks a pass


def attention_max_tokens(d: int, *, policy: bool = False, backward: bool = False) -> int:
    """The longest sequence the attention cores take at head width d, in
    policy mode or not, forward alone or both ways (the backward with the
    forward it recomputes); 0 for a width they do not take. Needs no card."""
    if not 0 < d <= MAX_HEAD_DIM:
        return 0
    dp = (d + 15) // 16 * 16
    tile = _BLK * dp * 2
    # the forward: two Q tiles, a ring of two K and V pairs, colsum(V)'s parts
    fwd_fixed = 6 * tile + (128 // (dp // 2) * dp * 4 if policy else 0)
    fwd = (SMEM_BYTES - fwd_fixed) // (8 if policy else 4) // _BLK * _BLK
    if not backward:
        return fwd
    # the backward: a pass's key blocks' K and V (two up to _NARROW, one past
    # it), a ring of two Q and dO pairs, the dS^T stages (four, one past
    # _NARROW) with dQ's fp32 sum (none past it), colsum(V) with its parts,
    # the fold's sums
    seg = 32 if dp >= 64 else 16 if dp >= 32 else 8
    narrow = dp <= _NARROW
    bwd_fixed = ((4 if narrow else 2) * tile + 4 * tile + (4 if narrow else 1) * _BLK * _BLK * 2
                 + (_BLK * dp * 4 if narrow else 0) + (1 + 8 * 32 // seg) * dp * 4 + 66 * 4)
    return min(fwd, (SMEM_BYTES - bwd_fixed) // 16 // _BLK * _BLK)


def check_tokens(N: int, d: int, what: str, *, policy: bool = False,
                 backward: bool = False) -> None:
    """ValueError naming the limit and its cause where the kernels do not
    take N tokens of width d (`attention_max_tokens`)."""
    limit = attention_max_tokens(d, policy=policy, backward=backward)
    if not 0 < N <= limit:
        raise ValueError(
            f"{what}: {N} tokens at head width {d}: the kernels take 1 to {limit} "
            f"({'policy' if policy else 'plain'} mode, "
            f"{'both ways' if backward else 'forward'}), where the rows the attention core "
            f"keeps of every {'query' if backward else 'key'} outgrow a CTA's "
            f"{SMEM_BYTES} bytes of shared memory")


def lse_is_float4(N: int, d: int, policy: bool) -> bool:
    """Whether the forward core's row statistics are (B, H, N) float4 (policy
    mode, and the csrc/attention_hd.cuh path: d != 64 or N > SHORT_TOKENS)
    rather than one fp32 log-sum-exp a row."""
    return policy or d != HEAD_DIM or N > SHORT_TOKENS


def layer_norm(x, weight, bias, eps, width=None):
    """LayerNorm with fp32 statistics and affine; result in x.dtype. With
    `width` (less than x's), the statistics and the affine over the first
    `width` columns and zeros past them: what the kernels compute on rows
    padded with zero columns (`ops.rowpad`), whose LayerNorm parameters are
    zero there."""
    n = x.shape[-1]
    if width is not None and width < n:
        y = layer_norm(x[..., :width], weight[:width], bias[:width], eps)
        return F.pad(y, (0, n - width))
    return F.layer_norm(
        x.float(), (n,), weight.float(), bias.float(), eps
    ).to(x.dtype)


def linear(x, weight, bias):
    """x @ weight.T + bias in x.dtype (weight in the torch (out, in) layout)."""
    return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float, *,
                        policy: torch.Tensor | None = None, eps: float = 1e-6,
                        return_cls: bool = False, prob_dropout=None):
    """Multi-head attention on packed (B, N, 3C) qkv -> (B, N, C).

    Scores in fp32, exact softmax (with a (B, N) `policy`, the policy
    softmax with smoothing `eps`), probabilities in the compute dtype. With
    `return_cls`, also the (B, H, N) CLS (query 0) row of the probabilities.
    prob_dropout: a function applied to the (B, H, N, N) probabilities
    before P.V (attention dropout); the CLS row is taken after it, as the
    JAX Attention takes it (`nn/layers.py:163-175`).
    """
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, N, 3, num_heads, C // num_heads).permute(
        2, 0, 3, 1, 4
    ).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if policy is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = softmax_with_policy(s, policy, eps)
    p = p.to(qkv.dtype)
    if prob_dropout is not None:
        p = prob_dropout(p)
    out = torch.matmul(p, v).transpose(1, 2).reshape(B, N, C)
    if return_cls:
        return out, p[:, :, 0]
    return out


def _residual(res, branch, s):
    """res + branch, or with a (B,) scale s, res + s * branch in fp32 rounded
    once to res.dtype."""
    if s is None:
        return res + branch
    return (res.float() + s.float().view(-1, 1, 1) * branch.float()).to(res.dtype)


def transformer_block_reference(x, w, num_heads, scale, ln_eps, *, policy=None, eps=1e-6,
                                stages=False, return_cls=False, branch_scales=None,
                                ln_width=None):
    """Plain torch version of the block's forward: `out`, then the CLS rows
    with `return_cls`, then the stages dict with `stages`. `ln_width`: the
    LayerNorms' width where x's rows end in zero columns (`layer_norm`)."""
    sa, sm = (None, None) if branch_scales is None else branch_scales
    qkv = linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps, ln_width), w["wqkv"], w["bqkv"])
    kw = {} if policy is None else {"policy": policy, "eps": eps}
    if return_cls:
        kw["return_cls"] = True
    attn = attention_reference(qkv, num_heads, scale, **kw)
    if return_cls:
        attn, cls = attn
    mid = _residual(x, linear(attn, w["wproj"], w["bproj"]), sa)
    h = layer_norm(mid, w["ln2_w"], w["ln2_b"], ln_eps, ln_width)
    hid = F.gelu(linear(h, w["w1"], w["b1"]).float()).to(x.dtype)
    out = _residual(mid, linear(hid, w["w2"], w["b2"]), sm)
    result = (out,)
    if return_cls:
        result += (cls,)
    if stages:
        result += ({"qkv": qkv, "attn": attn, "mid": mid, "hid": hid},)
    return result if len(result) > 1 else out


def transformer_block_backward_reference(x, g, w, num_heads, scale, ln_eps, *, policy=None,
                                         eps=1e-6, policy_grad=True, branch_scales=None,
                                         ln_width=None):
    """Plain torch version of `fused_transformer_block_backward`: autograd
    through `transformer_block_reference`. Returns (dx in x.dtype, grads in
    fp32 keyed like `w` with None for a None weight, dPolicy in fp32 or
    None): dPolicy only with a policy and `policy_grad`. The policy enters
    in fp32, as the kernel takes it. The inputs must not be inference
    tensors."""
    with torch.enable_grad():
        xs = x.detach().clone().requires_grad_()
        ws = {k: None if v is None else v.detach().clone().requires_grad_()
              for k, v in w.items()}
        pol = None
        if policy is not None:
            pol = policy.detach().float().clone().requires_grad_(policy_grad)
        scales = None if branch_scales is None else tuple(t.detach() for t in branch_scales)
        out = transformer_block_reference(xs, ws, num_heads, scale, ln_eps, policy=pol, eps=eps,
                                          branch_scales=scales, ln_width=ln_width)
        keys = [k for k in BLOCK_WEIGHT_KEYS if ws[k] is not None]
        inputs = [xs] + [ws[k] for k in keys]
        if pol is not None and policy_grad:
            inputs.append(pol)
        grads = torch.autograd.grad(out, inputs, g)
    dw = dict.fromkeys(BLOCK_WEIGHT_KEYS)
    dw.update({k: d.float() for k, d in zip(keys, grads[1:])})
    dpol = grads[-1] if pol is not None and policy_grad else None
    return grads[0], dw, dpol


def head_width(C: int, num_heads: int, what: str) -> int:
    """The head width d = C / num_heads, if the kernels take it (1 to
    MAX_HEAD_DIM, odd or even); else ValueError naming it. The wrappers call
    it before anything touches the device."""
    d = C // num_heads if num_heads > 0 else 0
    if num_heads <= 0 or d * num_heads != C or not 0 < d <= MAX_HEAD_DIM:
        width = f"{C / num_heads:g}" if num_heads > 0 else "undefined"
        raise ValueError(f"{what}: head width {width} (C={C}, {num_heads} heads): the kernels "
                         f"take a width from 1 to {MAX_HEAD_DIM}")
    return d


def _kernel_args(x, w, num_heads, what, *, policy=False, backward=False):
    """Checks shared by the kernel wrappers, at the widths the kernels take
    (`ops.rowpad`'s, where the caller's rows were padded): `check_tokens` in
    the mode and direction given, and the backward's LayerNorm width;
    returns (hidden, the weight pointers in BLOCK_WEIGHT_KEYS order, their
    dtypes and shapes)."""
    B, N, C = x.shape
    d = head_width(C, num_heads, what)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}: need a CUDA or CPU tensor")
    check_tokens(N, d, what, policy=policy, backward=backward)
    if backward:
        check_ln_width(C, what)
    hidden = w["w1"].shape[0]
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    shapes = {
        "ln1_w": (f32, (C,)), "ln1_b": (f32, (C,)),
        "wqkv": (bf16, (3 * C, C)), "bqkv": (f32, (3 * C,)),
        "wproj": (bf16, (C, C)), "bproj": (f32, (C,)),
        "ln2_w": (f32, (C,)), "ln2_b": (f32, (C,)),
        "w1": (bf16, (hidden, C)), "b1": (f32, (hidden,)),
        "w2": (bf16, (C, hidden)), "b2": (f32, (C,)),
    }
    ptrs = [_cuda.ptr(w[k], k, dev, *shapes[k]) for k in BLOCK_WEIGHT_KEYS]
    return hidden, ptrs, shapes


def _policy_arg(policy, x, what):
    """The (B, N) policy as the kernels take it, fp32 and contiguous, or None."""
    if policy is None:
        return None
    B, N, _ = x.shape
    pol = policy.detach().reshape(B, N) if policy.numel() == B * N else None
    if pol is None or not pol.is_floating_point():
        raise ValueError(f"{what}: policy must be a float (B, N) = {(B, N)} keep mask, "
                         f"got {policy.dtype} {tuple(policy.shape)}")
    return pol.float().contiguous()


def _scales_arg(branch_scales, x, what):
    """(sa, sm) as the kernels take them, fp32 (B,) and contiguous on x's
    device, or (None, None)."""
    if branch_scales is None:
        return None, None
    B = x.shape[0]
    out = []
    for name, t in zip(("sa", "sm"), branch_scales):
        if t.shape != (B,) or not t.is_floating_point():
            raise ValueError(f"{what}: {name} must be a float (B,) = ({B},) vector, got "
                             f"{t.dtype} {tuple(t.shape)}")
        out.append(t.detach().float().contiguous())
    return tuple(out)


def _count(fn, policy, sa):
    """One launch of `fn`'s kernel, counted by mode."""
    if sa is not None:
        fn.scaled_launches += 1
    elif policy is None:
        fn.launches += 1
    else:
        fn.policy_launches += 1


def needs_grad(x, w, policy) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(v is not None and v.requires_grad for v in w.values())
        or (policy is not None and policy.requires_grad))


def _refuse_autograd(x, w, policy, what):
    if needs_grad(x, w, policy):
        raise RuntimeError(
            f"{what} is not differentiable on the card: under autograd use "
            "fused_transformer_block_trainable"
        )


def _launch_forward(x, w, num_heads, scale, ln_eps, *, policy, eps, cls, what,
                    branch_scales=None):
    """One d2s_block_forward call: (out, stages, cls rows or None); rows of
    a width the kernels do not take padded to one (`ops.rowpad`)."""
    _refuse_autograd(x, w, policy, what)
    kw = dict(policy=policy, eps=eps, cls=cls, what=what, branch_scales=branch_scales)
    L = rowpad.block_layout(x.shape[2], num_heads, w["w1"].shape[0])
    if L is None:
        return _kernel_forward(x, w, num_heads, scale, ln_eps, x.shape[2], **kw)
    return rowpad.count(what, padded_forward(x, w, L, lambda xp, wp: _kernel_forward(
        xp, wp, num_heads, scale, ln_eps, L.C, **kw)))


def padded_forward(x, w, layout, kernel):
    """The block's forward at `layout`'s padded widths: `kernel(xp, wp)` ->
    (out, stages, cls rows or None) on the padded rows and weights, its out
    and stages unpadded."""
    out, st, cls = kernel(rowpad.pad(x, layout, "C"), rowpad.pad_weights(w, layout))
    return rowpad.unpad(out, layout, "C"), rowpad.unpad_stages(st, layout), cls


def padded_backward(x, g, w, layout, kernel):
    """The block's backward at `layout`'s padded widths: `kernel(xp, gp,
    wp)` -> (dx, dw, dPolicy) on the padded rows, cotangent and weights;
    dx and every gradient unpadded, so that the pads' gradients reach no
    parameter."""
    dx, dw, dpol = kernel(rowpad.pad(x, layout, "C"), rowpad.pad(g, layout, "C"),
                          rowpad.pad_weights(w, layout))
    return rowpad.unpad(dx, layout, "C"), rowpad.unpad_weights(dw, layout), dpol


def _kernel_forward(x, w, num_heads, scale, ln_eps, ln_c, *, policy, eps, cls, what,
                    branch_scales=None):
    B, N, C = x.shape
    hidden, ptrs, _ = _kernel_args(x, w, num_heads, what, policy=policy is not None)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    pol = _policy_arg(policy, x, what)
    sa, sm = _scales_arg(branch_scales, x, what)
    out = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=bf16, device=dev)
    attn = torch.empty_like(x)
    mid = torch.empty_like(x)
    hid = torch.empty((B, N, hidden), dtype=bf16, device=dev)
    stats = torch.empty((B * N, 2), dtype=torch.float32, device=dev)
    cls_rows = torch.empty((B, num_heads, N), dtype=bf16, device=dev) if cls else None
    err = _cuda.library().d2s_block_forward(
        x_ptr, out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        mid.data_ptr(), hid.data_ptr(), stats.data_ptr(), *ptrs,
        0, 0, 0 if cls_rows is None else cls_rows.data_ptr(),
        _cuda.ptr(pol, "policy", dev, f32, (B, N)),
        _cuda.ptr(sa, "sa", dev, f32, (B,)), _cuda.ptr(sm, "sm", dev, f32, (B,)),
        B, N, C, num_heads, hidden, ln_c, float(scale), float(ln_eps), float(eps),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_forward")
    if cls:
        fused_transformer_block_cls.launches += 1
    else:
        _count(fused_transformer_block, policy, sa)
    return out, {"qkv": qkv, "attn": attn, "mid": mid, "hid": hid}, cls_rows


def _check_x(x):
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    return x.shape[2]


# the custom ops take the weights as one list (BLOCK_WEIGHT_KEYS without the
# optional bqkv) and bqkv apart
_OP_KEYS = tuple(k for k in BLOCK_WEIGHT_KEYS if k != "bqkv")


def _op_weights(w: dict) -> list:
    return [w[k] for k in _OP_KEYS]


def _weights_dict(weights, bqkv) -> dict:
    return dict(zip(_OP_KEYS, weights), bqkv=bqkv)


def _scales(sa, sm):
    return None if sa is None else (sa, sm)


@torch.library.custom_op("d2s::block_forward", mutates_args=(), device_types="cpu")
def _block_forward_op(x: torch.Tensor, weights: List[torch.Tensor], bqkv: Optional[torch.Tensor],
                      policy: Optional[torch.Tensor], sa: Optional[torch.Tensor],
                      sm: Optional[torch.Tensor], num_heads: int, scale: float,
                      ln_eps: float, eps: float) -> torch.Tensor:
    return transformer_block_reference(x, _weights_dict(weights, bqkv), num_heads, scale,
                                       ln_eps, policy=policy, eps=eps,
                                       branch_scales=_scales(sa, sm))


@_block_forward_op.register_kernel("cuda")
def _(x, weights, bqkv, policy, sa, sm, num_heads, scale, ln_eps, eps):
    return _launch_forward(x, _weights_dict(weights, bqkv), num_heads, scale, ln_eps,
                           policy=policy, eps=eps, cls=False, what="fused_transformer_block",
                           branch_scales=_scales(sa, sm))[0]


@_block_forward_op.register_fake
def _(x, weights, bqkv, policy, sa, sm, num_heads, scale, ln_eps, eps):
    return torch.empty_like(x)


@torch.library.custom_op("d2s::block_forward_cls", mutates_args=(), device_types="cpu")
def _block_forward_cls_op(x: torch.Tensor, weights: List[torch.Tensor],
                          bqkv: Optional[torch.Tensor], policy: Optional[torch.Tensor],
                          num_heads: int, scale: float, ln_eps: float,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return transformer_block_reference(x, _weights_dict(weights, bqkv), num_heads, scale,
                                       ln_eps, policy=policy, eps=eps, return_cls=True)


@_block_forward_cls_op.register_kernel("cuda")
def _(x, weights, bqkv, policy, num_heads, scale, ln_eps, eps):
    out, _, cls = _launch_forward(x, _weights_dict(weights, bqkv), num_heads, scale, ln_eps,
                                  policy=policy, eps=eps, cls=True,
                                  what="fused_transformer_block_cls")
    return out, cls


@_block_forward_cls_op.register_fake
def _(x, weights, bqkv, policy, num_heads, scale, ln_eps, eps):
    B, N, _ = x.shape
    return torch.empty_like(x), x.new_empty((B, num_heads, N))


def fused_transformer_block(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    policy: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    eps: float = 1e-6,
    ln_eps: float = 1e-6,
    stages: bool = False,
    branch_scales=None,
):
    """One whole pre-norm block, (B, N, C) -> (B, N, C).

    With a (B, N) keep `policy` (fp32 or bf16), the attention is the policy
    softmax with smoothing `eps`. With `branch_scales` (sa, sm), the two
    branches are scaled per sample (DropPath). With `stages`, returns (out,
    {"qkv", "attn", "mid", "hid"}): the intermediates the block computes on the way
    (qkv projection, attention core output, x_mid, GELU(fc1) activation), so
    that each can be checked on its own. On the card it is not
    differentiable: under autograd it raises
    (`fused_transformer_block_trainable` is). Plain-mode launches count in
    `launches`, policy-mode ones in `policy_launches`, those with branch
    scales in `scaled_launches`.
    """
    C = _check_x(x)
    what = "fused_transformer_block"
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu" and (stages or needs_grad(x, w, policy)):
        return transformer_block_reference(x, w, num_heads, scale, ln_eps, policy=policy,
                                           eps=eps, stages=stages, branch_scales=branch_scales)
    head_width(C, num_heads, what)
    if stages:
        out, st, _ = _launch_forward(x, w, num_heads, scale, ln_eps, policy=policy, eps=eps,
                                     cls=False, what=what, branch_scales=branch_scales)
        return out, st
    _refuse_autograd(x, w, policy, what)
    return torch.ops.d2s.block_forward(x, _op_weights(w), w["bqkv"],
                                       _policy_arg(policy, x, what),
                                       *_scales_arg(branch_scales, x, what),
                                       num_heads, float(scale), float(ln_eps), float(eps))


def fused_transformer_block_cls(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    policy: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    eps: float = 1e-6,
    ln_eps: float = 1e-6,
):
    """The block with its CLS-attention output: (out, cls) where cls is the
    (B, H, N) query-0 row of every head's attention probabilities, in
    x.dtype (in policy mode (e_0j + eps/N) / den_0, as the policy softmax
    gives it). Not differentiable on the card."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu" and needs_grad(x, w, policy):
        return transformer_block_reference(x, w, num_heads, scale, ln_eps, policy=policy,
                                           eps=eps, return_cls=True)
    head_width(C, num_heads, "fused_transformer_block_cls")
    _refuse_autograd(x, w, policy, "fused_transformer_block_cls")
    return torch.ops.d2s.block_forward_cls(x, _op_weights(w), w["bqkv"],
                                           _policy_arg(policy, x, "fused_transformer_block_cls"),
                                           num_heads, float(scale), float(ln_eps), float(eps))


def fused_transformer_block_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    w: dict,
    num_heads: int,
    policy: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    eps: float = 1e-6,
    ln_eps: float = 1e-6,
    policy_grad: bool = True,
    branch_scales=None,
):
    """The block's backward from its input x and the cotangent g of its
    output: (dx in x.dtype, {key: fp32 gradient summed over the batch},
    dPolicy), with the keys of `w` (None where the weight is None). dPolicy
    is the (B, N) fp32 gradient of the keep policy, None in plain mode or
    with `policy_grad=False`, which spares the kernel its work. With
    `branch_scales` (sa, sm), the block's branches are scaled as in the
    forward; they get no gradient. Plain-mode launches count in `launches`,
    policy-mode ones in `policy_launches`, those with branch scales in
    `scaled_launches`."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return transformer_block_backward_reference(x, g, w, num_heads, scale, ln_eps,
                                                    policy=policy, eps=eps,
                                                    policy_grad=policy_grad,
                                                    branch_scales=branch_scales)
    what = "fused_transformer_block_backward"
    kw = dict(policy=policy, eps=eps, policy_grad=policy_grad, branch_scales=branch_scales)
    head_width(C, num_heads, what)
    L = rowpad.block_layout(C, num_heads, w["w1"].shape[0])
    if L is None:
        return _kernel_backward(x, g, w, num_heads, scale, ln_eps, C, **kw)
    return rowpad.count(what, padded_backward(x, g, w, L, lambda xp, gp, wp: _kernel_backward(
        xp, gp, wp, num_heads, scale, ln_eps, L.C, **kw)))


def _kernel_backward(x, g, w, num_heads, scale, ln_eps, ln_c, *, policy, eps, policy_grad,
                     branch_scales):
    """One d2s_block_backward call at widths the kernels take."""
    what = "fused_transformer_block_backward"
    B, N, C = x.shape
    hidden, ptrs, shapes = _kernel_args(x, w, num_heads, what, policy=policy is not None,
                                        backward=True)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    g_ptr = _cuda.ptr(g, "g", dev, bf16, (B, N, C))
    pol = _policy_arg(policy, x, what)
    sa, sm = _scales_arg(branch_scales, x, what)
    lib = _cuda.library()
    nbytes = lib.d2s_block_backward_scratch_bytes(B, N, C, num_heads, hidden, int(pol is not None))
    if nbytes <= 0:
        raise ValueError(f"{what}: shapes {(B, N, C)}, {num_heads} heads, hidden "
                         f"{hidden}: not taken by the kernel")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dw = {k: None if w[k] is None else torch.empty(shapes[k][1], dtype=f32, device=dev)
          for k in BLOCK_WEIGHT_KEYS}
    dpol = torch.empty((B, N), dtype=f32, device=dev) if pol is not None and policy_grad else None
    err = lib.d2s_block_backward(
        x_ptr, g_ptr, dx.data_ptr(), *ptrs,
        *(0 if dw[k] is None else dw[k].data_ptr() for k in BLOCK_WEIGHT_KEYS),
        _cuda.ptr(pol, "policy", dev, f32, (B, N)), 0 if dpol is None else dpol.data_ptr(),
        _cuda.ptr(sa, "sa", dev, f32, (B,)), _cuda.ptr(sm, "sm", dev, f32, (B,)),
        scratch.data_ptr(), B, N, C, num_heads, hidden, ln_c, float(scale),
        float(ln_eps), float(eps), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_backward")
    _count(fused_transformer_block_backward, policy, sa)
    return dx, dw, dpol


class _TrainableBlock(torch.autograd.Function):
    """Forward `fused_transformer_block`, backward
    `fused_transformer_block_backward`, which recomputes the forward from x:
    only x, the policy, the branch scales and the weights are kept between
    the two; the scales get no gradient. The
    gradients come back in each weight's dtype and dPolicy in the policy's,
    as the JAX package's custom VJP casts them, and None for a weight that
    needs none (a frozen model's input gradient); dPolicy is asked of the
    kernel only when the policy needs a gradient (the threshold path's
    policy comes from stopped scores and does not)."""

    @staticmethod
    def forward(ctx, x, policy, sa, sm, num_heads, scale, ln_eps, eps, *weights):
        ctx.save_for_backward(x, policy, sa, sm, *weights)
        ctx.args = (num_heads, scale, ln_eps, eps)
        w = dict(zip(BLOCK_WEIGHT_KEYS, weights))
        return fused_transformer_block(x, w, num_heads, policy, scale=scale, eps=eps,
                                       ln_eps=ln_eps, branch_scales=_scales(sa, sm))

    @staticmethod
    def backward(ctx, g):
        x, policy, sa, sm, *weights = ctx.saved_tensors
        num_heads, scale, ln_eps, eps = ctx.args
        w = dict(zip(BLOCK_WEIGHT_KEYS, weights))
        policy_grad = policy is not None and ctx.needs_input_grad[1]
        dx, dw, dpol = fused_transformer_block_backward(
            x, g.contiguous(), w, num_heads, policy, scale=scale, eps=eps, ln_eps=ln_eps,
            policy_grad=policy_grad, branch_scales=_scales(sa, sm))
        # a frozen weight's gradient (the kernel computes it) is not kept
        grads = [None if w[k] is None or not ctx.needs_input_grad[8 + i]
                 else dw[k].to(w[k].dtype) for i, k in enumerate(BLOCK_WEIGHT_KEYS)]
        if dpol is not None:
            dpol = dpol.to(policy.dtype).reshape(policy.shape)
        return (dx, dpol, None, None, None, None, None, None, *grads)


def fused_transformer_block_trainable(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    policy: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    eps: float = 1e-6,
    ln_eps: float = 1e-6,
    branch_scales=None,
):
    """`fused_transformer_block` with a gradient for x, every weight and, in
    policy mode, the policy; `branch_scales` (sa, sm), DropPath's (B,)
    multipliers, get none."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    sa, sm = (None, None) if branch_scales is None else (t.detach() for t in branch_scales)
    return _TrainableBlock.apply(
        x, policy, sa, sm, num_heads, float(scale), float(ln_eps), float(eps),
        *(w[k] for k in BLOCK_WEIGHT_KEYS))


fused_transformer_block.launches = 0
fused_transformer_block.policy_launches = 0
fused_transformer_block.scaled_launches = 0
fused_transformer_block_cls.launches = 0
fused_transformer_block_backward.launches = 0
fused_transformer_block_backward.policy_launches = 0
fused_transformer_block_backward.scaled_launches = 0
