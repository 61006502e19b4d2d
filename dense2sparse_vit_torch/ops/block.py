"""Whole pre-norm transformer block, inference.

`fused_transformer_block` is the port of
`dense2sparse_vit_tpu/ops/pallas/block.py::fused_transformer_block` in its
plain mode (no policy, no CLS output, no branch scales):

    x_mid = x + proj(MHA(qkv(LN1 x)))
    out   = x_mid + fc2(GELU(fc1(LN2 x_mid)))

with an exact fp32 row-max softmax over the N real tokens, which is what the
JAX package's `_ref_block` defines. For a CUDA tensor it launches
`csrc/block.cu`; for a CPU tensor it runs `transformer_block_reference`, the
plain torch version.

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
HEAD_DIM = 64  # the kernel's head width
MAX_TOKENS = 800  # the kernel keeps a sample-head's K and V in shared memory


def layer_norm(x, weight, bias, eps):
    """LayerNorm with fp32 statistics and affine; result in x.dtype."""
    return F.layer_norm(
        x.float(), (x.shape[-1],), weight.float(), bias.float(), eps
    ).to(x.dtype)


def linear(x, weight, bias):
    """x @ weight.T + bias in x.dtype (weight in the torch (out, in) layout)."""
    return F.linear(x, weight, None if bias is None else bias.to(x.dtype))


def attention_reference(qkv: torch.Tensor, num_heads: int, scale: float):
    """Multi-head attention on packed (B, N, 3C) qkv -> (B, N, C).

    Scores in fp32, exact softmax, probabilities in the compute dtype.
    """
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = qkv.view(B, N, 3, num_heads, C // num_heads).permute(
        2, 0, 3, 1, 4
    ).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(B, N, C)


def transformer_block_reference(x, w, num_heads, scale, ln_eps, *, stages=False):
    """Plain torch version of `fused_transformer_block`."""
    qkv = linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"])
    attn = attention_reference(qkv, num_heads, scale)
    mid = x + linear(attn, w["wproj"], w["bproj"])
    h = layer_norm(mid, w["ln2_w"], w["ln2_b"], ln_eps)
    hid = F.gelu(linear(h, w["w1"], w["b1"]).float()).to(x.dtype)
    out = mid + linear(hid, w["w2"], w["b2"])
    if stages:
        return out, {"qkv": qkv, "attn": attn, "mid": mid, "hid": hid}
    return out


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
    on its own.
    """
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    B, N, C = x.shape
    if scale is None:
        scale = (C // num_heads) ** -0.5
    if x.device.type == "cpu":
        return transformer_block_reference(x, w, num_heads, scale, ln_eps, stages=stages)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: need a CUDA or CPU tensor")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_transformer_block has no backward kernel yet")
    if C != HEAD_DIM * num_heads:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, got {C}/{num_heads}")
    if N > MAX_TOKENS:
        raise ValueError(f"the kernel takes at most {MAX_TOKENS} tokens, got {N}")
    hidden = w["w1"].shape[0]
    if hidden % 8:
        raise ValueError(f"hidden={hidden}: need a multiple of 8")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    shapes = {
        "ln1_w": (f32, (C,)), "ln1_b": (f32, (C,)),
        "wqkv": (bf16, (3 * C, C)), "bqkv": (f32, (3 * C,)),
        "wproj": (bf16, (C, C)), "bproj": (f32, (C,)),
        "ln2_w": (f32, (C,)), "ln2_b": (f32, (C,)),
        "w1": (bf16, (hidden, C)), "b1": (f32, (hidden,)),
        "w2": (bf16, (C, hidden)), "b2": (f32, (C,)),
    }
    ptrs = [
        _cuda.ptr(w[k], k, dev, *shapes[k]) for k in BLOCK_WEIGHT_KEYS
    ]
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    out = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=bf16, device=dev)
    attn = torch.empty_like(x)
    mid = torch.empty_like(x)
    hid = torch.empty((B, N, hidden), dtype=bf16, device=dev)
    stats = torch.empty((B * N, 2), dtype=f32, device=dev)
    err = _cuda.library().d2s_block_forward(
        x_ptr, out.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
        mid.data_ptr(), hid.data_ptr(), stats.data_ptr(), *ptrs,
        B, N, C, num_heads, hidden, float(scale), float(ln_eps),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_forward")
    fused_transformer_block.launches += 1
    if stages:
        return out, {"qkv": qkv, "attn": attn, "mid": mid, "hid": hid}
    return out


fused_transformer_block.launches = 0

