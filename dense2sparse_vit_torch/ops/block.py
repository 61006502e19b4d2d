"""Whole pre-norm transformer block, both directions.

The port of `dense2sparse_vit_tpu/ops/pallas/block.py` in its plain mode (no
keep-policy, no DropPath branch scales):

    x_mid = x + proj(MHA(qkv(LN1 x)))
    out   = x_mid + fc2(GELU(fc1(LN2 x_mid)))

with an exact fp32 row-max softmax over the N real tokens, which is what the
JAX package's `_ref_block` defines.

- `fused_transformer_block`: the forward (`fused_transformer_block`);
- `fused_transformer_block_cls`: the same with the CLS row of every head's
  attention probabilities as a second output (the TPU kernel's
  `return_cls=True`), which the teacher hands to the mask loss;
- `fused_transformer_block_backward`: dx and the twelve parameter
  gradients from x and the output's cotangent, recomputing the forward
  (`fused_transformer_block_backward`);
- `fused_transformer_block_trainable`: the block as an autograd Function,
  forward `fused_transformer_block`, backward
  `fused_transformer_block_backward` (`fused_transformer_block_trainable`).

For CUDA tensors the wrappers launch `csrc/block.cu` and `csrc/block_bwd.cu`;
for CPU tensors they run `transformer_block_reference` and
`transformer_block_backward_reference`, the plain torch versions.

Weights are a dict with the keys of `BLOCK_WEIGHT_KEYS`: the matrices in the
torch Linear layout (out, in) and the compute dtype, the LayerNorm
parameters and biases in fp32; `bqkv` may be None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda

BLOCK_WEIGHT_KEYS = (
    "ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj",
    "ln2_w", "ln2_b", "w1", "b1", "w2", "b2",
)
HEAD_DIM = 64  # the kernels' head width
MAX_TOKENS = 800  # the forward keeps a sample-head's K and V in shared memory
BWD_MAX_TOKENS = 384  # the backward keeps its Q, K, V and dO there


def layer_norm(x, weight, bias, eps):
    """LayerNorm with fp32 statistics and affine; result in x.dtype."""
    return F.layer_norm(
        x.float(), (x.shape[-1],), weight.float(), bias.float(), eps
    ).to(x.dtype)


def linear(x, weight, bias):
    """x @ weight.T + bias in x.dtype (weight in the torch (out, in) layout)."""
    return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float, *,
                        return_cls: bool = False):
    """Multi-head attention on packed (B, N, 3C) qkv -> (B, N, C).

    Scores in fp32, exact softmax, probabilities in the compute dtype. With
    `return_cls`, also the (B, H, N) CLS (query 0) row of the probabilities.
    """
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, N, 3, num_heads, C // num_heads).permute(
        2, 0, 3, 1, 4
    ).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    out = torch.matmul(p, v).transpose(1, 2).reshape(B, N, C)
    if return_cls:
        return out, p[:, :, 0]
    return out


def transformer_block_reference(x, w, num_heads, scale, ln_eps, *, stages=False,
                                return_cls=False):
    """Plain torch version of the block's forward: `out`, then the CLS rows
    with `return_cls`, then the stages dict with `stages`."""
    qkv = linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"])
    if return_cls:
        attn, cls = attention_reference(qkv, num_heads, scale, return_cls=True)
    else:
        attn = attention_reference(qkv, num_heads, scale)
    mid = x + linear(attn, w["wproj"], w["bproj"])
    h = layer_norm(mid, w["ln2_w"], w["ln2_b"], ln_eps)
    hid = F.gelu(linear(h, w["w1"], w["b1"]).float()).to(x.dtype)
    out = mid + linear(hid, w["w2"], w["b2"])
    result = (out,)
    if return_cls:
        result += (cls,)
    if stages:
        result += ({"qkv": qkv, "attn": attn, "mid": mid, "hid": hid},)
    return result if len(result) > 1 else out


def transformer_block_backward_reference(x, g, w, num_heads, scale, ln_eps):
    """Plain torch version of `fused_transformer_block_backward`: autograd
    through `transformer_block_reference`. Returns (dx in x.dtype, grads in
    fp32 keyed like `w`, None for a None weight). The inputs must not be
    inference tensors."""
    with torch.enable_grad():
        xs = x.detach().clone().requires_grad_()
        ws = {k: None if v is None else v.detach().clone().requires_grad_()
              for k, v in w.items()}
        out = transformer_block_reference(xs, ws, num_heads, scale, ln_eps)
        keys = [k for k in BLOCK_WEIGHT_KEYS if ws[k] is not None]
        grads = torch.autograd.grad(out, [xs] + [ws[k] for k in keys], g)
    dw = dict.fromkeys(BLOCK_WEIGHT_KEYS)
    dw.update({k: d.float() for k, d in zip(keys, grads[1:])})
    return grads[0], dw


def _kernel_args(x, w, num_heads, max_tokens, what):
    """Checks shared by the kernel wrappers; returns (hidden, the weight
    pointers in BLOCK_WEIGHT_KEYS order, their dtypes and shapes)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}: need a CUDA or CPU tensor")
    B, N, C = x.shape
    if C != HEAD_DIM * num_heads:
        raise ValueError(f"{what}: the kernel takes head_dim {HEAD_DIM}, got {C}/{num_heads}")
    if N > max_tokens:
        raise ValueError(f"{what}: the kernel takes at most {max_tokens} tokens, got {N}")
    hidden = w["w1"].shape[0]
    if hidden % 8:
        raise ValueError(f"{what}: hidden={hidden}: need a multiple of 8")
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


def _refuse_autograd(x, w, what):
    if torch.is_grad_enabled() and (
        x.requires_grad or any(v is not None and v.requires_grad for v in w.values())
    ):
        raise RuntimeError(
            f"{what} is not differentiable on the card: under autograd use "
            "fused_transformer_block_trainable"
        )


def _launch_forward(x, w, num_heads, scale, ln_eps, *, cls, what):
    """One d2s_block_forward call: (out, stages, cls rows or None)."""
    _refuse_autograd(x, w, what)
    B, N, C = x.shape
    hidden, ptrs, _ = _kernel_args(x, w, num_heads, MAX_TOKENS, what)
    dev, bf16 = x.device, torch.bfloat16
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
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
        B, N, C, num_heads, hidden, float(scale), float(ln_eps),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_forward")
    return out, {"qkv": qkv, "attn": attn, "mid": mid, "hid": hid}, cls_rows


def _check_x(x):
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    return x.shape[2]


def fused_transformer_block(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    *,
    scale: float | None = None,
    ln_eps: float = 1e-6,
    stages: bool = False,
):
    """One whole pre-norm block, (B, N, C) -> (B, N, C).

    With `stages`, returns (out, {"qkv", "attn", "mid", "hid"}): the
    intermediates the block computes on the way (qkv projection, attention
    core output, x_mid, GELU(fc1) activation), so that each can be checked
    on its own. On the card it is not differentiable: under autograd it
    raises (`fused_transformer_block_trainable` is).
    """
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return transformer_block_reference(x, w, num_heads, scale, ln_eps, stages=stages)
    out, st, _ = _launch_forward(x, w, num_heads, scale, ln_eps, cls=False,
                                 what="fused_transformer_block")
    fused_transformer_block.launches += 1
    return (out, st) if stages else out


def fused_transformer_block_cls(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    *,
    scale: float | None = None,
    ln_eps: float = 1e-6,
):
    """The block with its CLS-attention output: (out, cls) where cls is the
    (B, H, N) query-0 row of every head's attention probabilities, in
    x.dtype. Not differentiable on the card."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return transformer_block_reference(x, w, num_heads, scale, ln_eps, return_cls=True)
    out, _, cls = _launch_forward(x, w, num_heads, scale, ln_eps, cls=True,
                                  what="fused_transformer_block_cls")
    fused_transformer_block_cls.launches += 1
    return out, cls


def fused_transformer_block_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    w: dict,
    num_heads: int,
    *,
    scale: float | None = None,
    ln_eps: float = 1e-6,
):
    """The block's backward from its input x and the cotangent g of its
    output: (dx in x.dtype, {key: fp32 gradient summed over the batch}),
    with the keys of `w` (None where the weight is None)."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return transformer_block_backward_reference(x, g, w, num_heads, scale, ln_eps)
    what = "fused_transformer_block_backward"
    B, N, _ = x.shape
    hidden, ptrs, shapes = _kernel_args(x, w, num_heads, BWD_MAX_TOKENS, what)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    g_ptr = _cuda.ptr(g, "g", dev, bf16, (B, N, C))
    lib = _cuda.library()
    nbytes = lib.d2s_block_backward_scratch_bytes(B, N, C, num_heads, hidden)
    if nbytes <= 0:
        raise ValueError(f"{what}: shapes {(B, N, C)}, {num_heads} heads, hidden "
                         f"{hidden}: not taken by the kernel")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dw = {k: None if w[k] is None else torch.empty(shapes[k][1], dtype=f32, device=dev)
          for k in BLOCK_WEIGHT_KEYS}
    err = lib.d2s_block_backward(
        x_ptr, g_ptr, dx.data_ptr(), *ptrs,
        *(0 if dw[k] is None else dw[k].data_ptr() for k in BLOCK_WEIGHT_KEYS),
        scratch.data_ptr(), B, N, C, num_heads, hidden, float(scale),
        float(ln_eps), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_backward")
    fused_transformer_block_backward.launches += 1
    return dx, dw


class _TrainableBlock(torch.autograd.Function):
    """Forward `fused_transformer_block`, backward
    `fused_transformer_block_backward`, which recomputes the forward from x:
    only x and the weights are kept between the two. The gradients come back
    in each weight's dtype, as the JAX package's custom VJP casts them."""

    @staticmethod
    def forward(ctx, x, num_heads, scale, ln_eps, *weights):
        ctx.save_for_backward(x, *weights)
        ctx.args = (num_heads, scale, ln_eps)
        w = dict(zip(BLOCK_WEIGHT_KEYS, weights))
        return fused_transformer_block(x, w, num_heads, scale=scale, ln_eps=ln_eps)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        num_heads, scale, ln_eps = ctx.args
        w = dict(zip(BLOCK_WEIGHT_KEYS, weights))
        dx, dw = fused_transformer_block_backward(
            x, g.contiguous(), w, num_heads, scale=scale, ln_eps=ln_eps)
        grads = [None if w[k] is None else dw[k].to(w[k].dtype)
                 for k in BLOCK_WEIGHT_KEYS]
        return (dx, None, None, None, *grads)


def fused_transformer_block_trainable(
    x: torch.Tensor,
    w: dict,
    num_heads: int,
    *,
    scale: float | None = None,
    ln_eps: float = 1e-6,
):
    """`fused_transformer_block` with a gradient for x and every weight."""
    C = _check_x(x)
    if scale is None:
        scale = (C // num_heads) ** -0.5
    return _TrainableBlock.apply(
        x, num_heads, float(scale), float(ln_eps), *(w[k] for k in BLOCK_WEIGHT_KEYS))


fused_transformer_block.launches = 0
fused_transformer_block_cls.launches = 0
fused_transformer_block_backward.launches = 0
