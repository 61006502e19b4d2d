"""Int8 post-training quantization and the W8A8 whole block.

The port of `dense2sparse_vit_tpu/ops/pallas/quant.py`: the four projections
of a policy-free pre-norm block (qkv, proj, fc1, fc2) run on int8 codes.

- weights: one symmetric scale per output channel, absmax / 127, quantized
  once (`quantize_weight`, `quantize_block_params`);
- activations: one symmetric scale per row, computed on the fly right before
  each product (`quantize_rows`);
- products accumulate exactly (int32 on the card; float64, exact for these
  sums, in the plain version) and are dequantized as
  acc * (row_scale * col_scale) + bias (`qmatmul`);
- LayerNorm, softmax, GELU and the residuals stay in fp32 or the compute
  dtype, and the attention core is the compute-dtype one of `ops.block`.

Rounding follows the JAX package: codes are round-half-to-even of h / s
(divided by the scale, not multiplied by its reciprocal), clipped to
+-127; the scale is max(absmax, 1e-8) / 127; qkv is rounded to the compute
dtype after dequantization; the attention output is in the compute dtype
before it is quantized; GELU takes the fc1 output rounded to the compute
dtype and returns the compute dtype; x_mid stays fp32 between the two
halves and the block's output is rounded once. The attention core is the
exact row-max softmax of `ops.block.attention_reference`: the TPU kernel's
+-30 logit clip is a TPU shortcut the port does not copy.

`fused_transformer_block_int8` launches `csrc/quant_block.cu` for a CUDA
tensor and runs `quant_block_reference`, the plain torch version, for a CPU
tensor. Its four products run on the GEMM engine's int8 instantiation
(`csrc/ln_gemm.cuh`), which `qgemm` runs alone (`csrc/gemm.cu`'s
`d2s_qgemm`; `qgemm_reference` on the CPU), and its four row quantizations
on `rowq_kernel` (rows of up to ROW_WARP_MAX values, a warp a row) or
`rowq_row_kernel` (longer rows up to ROW_MAX, a CTA a row), which
`row_quantize` runs alone (`d2s_rowq`; `row_quantize_reference`), so that
each can be tested and timed at the block's shapes. The library counts
`rowq_row_kernel`'s launches, inside the block too: `ROWQ_ROWS.launches`.

Weights are in the torch Linear layout (out, in): `quantize_weight` takes
the absmax of each row, where the JAX package, whose kernels are (in, out),
takes each column's.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda, rowpad
from dense2sparse_vit_torch.ops.block import attention_reference, check_tokens, head_width
from dense2sparse_vit_torch.ops.norm import LaunchCount

QMAX = 127.0
SCALE_FLOOR = 1e-8
# The kernels quantize rows of at most ROW_MAX values (past ViT-e's MLP
# width of 15,360; the library's d2s_rowq_max_width), those past
# ROW_WARP_MAX (ViT-L's MLP width) a CTA a row.
ROW_WARP_MAX = 4096
ROW_MAX = 16384
ROWQ_ROWS = LaunchCount(0, "d2s_quant_launches")
# the quantized block's weights, in the order the kernel takes them
INT8_WEIGHT_KEYS = (
    "ln1_w", "ln1_b", "wqkv_q", "sqkv", "bqkv", "wproj_q", "sproj", "bproj",
    "ln2_w", "ln2_b", "w1_q", "s1", "b1", "w2_q", "s2", "b2",
)
# (float weight, its codes, its scales) for the four projections
_PROJECTIONS = (("wqkv", "wqkv_q", "sqkv"), ("wproj", "wproj_q", "sproj"),
                ("w1", "w1_q", "s1"), ("w2", "w2_q", "s2"))


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    # divided by a tensor: torch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from absmax / 127
    return torch.clamp(absmax, min=SCALE_FLOOR) / torch.full_like(absmax, QMAX)


def _codes(h32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(h32 / s), -QMAX, QMAX).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """(out, in) weight -> (int8 codes (out, in), fp32 scales (out,)): one
    symmetric scale per output channel."""
    w32 = w.float()
    s = _scale(w32.abs().amax(dim=1))
    return _codes(w32, s[:, None]), s


def quantize_matrices(w: dict) -> dict:
    """The four matrices of one block's weights (the `ops.block` layout)
    as codes and scales, under the keys of INT8_WEIGHT_KEYS."""
    out = {}
    for key, q_key, s_key in _PROJECTIONS:
        out[q_key], out[s_key] = quantize_weight(w[key])
    return out


def quantize_block_params(w: dict) -> dict:
    """Quantize one block's weights (the `ops.block` layout, matrices in the
    compute dtype): the four matrices become codes and scales
    (`quantize_matrices`), LayerNorm parameters and biases go to fp32."""
    out = {k: None if w[k] is None else w[k].float()
           for k in ("ln1_w", "ln1_b", "bqkv", "bproj", "ln2_w", "ln2_b", "b1", "b2")}
    return {**out, **quantize_matrices(w)}


def quantize_rows(h32: torch.Tensor):
    """Per-row symmetric int8 of an fp32 tensor: (codes, scales) with the
    scales of shape (..., 1)."""
    s = _scale(h32.abs().amax(dim=-1, keepdim=True))
    return _codes(h32, s), s


def row_quantize_takes(K: int) -> bool:
    """Whether the row quantization takes rows of K values: any K up to
    ROW_MAX (rows that are no multiple of 8 padded with zeros, `ops.rowpad`).
    Needs no card."""
    return 0 < K <= ROW_MAX


def check_rows(C: int, hidden: int, what: str) -> None:
    """ValueError naming the ceiling where the int8 block's row
    quantizations do not take its widths (rows of at most ROW_MAX values,
    as the block's kernels take them: widths that are no multiple of 16
    padded, `ops.rowpad`). Needs no card."""
    if not 0 < max(C, hidden) <= ROW_MAX:
        raise ValueError(f"{what}: C={C}, hidden={hidden}: the kernel takes rows of at most "
                         f"{ROW_MAX} values")


def row_quantize_reference(h: torch.Tensor, ln_w=None, ln_b=None, ln_eps: float = 1e-6,
                           ln_width=None):
    """Plain torch version of `row_quantize`: `quantize_rows` of h in fp32,
    normalised first by `layer_norm_f32` (over `ln_width` columns, where the
    rows end in zeros) where ln_w is given."""
    h32 = h.float() if ln_w is None else layer_norm_f32(h.float(), ln_w, ln_b, ln_eps, ln_width)
    q, s = quantize_rows(h32)
    return q, s[..., 0]


def row_quantize(h: torch.Tensor, ln_w=None, ln_b=None, ln_eps: float = 1e-6):
    """One of the int8 block's row quantizations alone: (codes (M, K) int8,
    scales (M,) fp32) of h (M, K) in bf16 or fp32, normalised first by its
    own LayerNorm (ln_w, ln_b (K,) fp32, ln_eps) where ln_w is given. A CUDA
    tensor launches the block's row kernel (any K up to ROW_MAX: rows that
    are no multiple of 8 go to it padded with zeros, the LayerNorm told
    their width); a CPU tensor runs `row_quantize_reference`. Launches count
    in `row_quantize.launches`."""
    if h.dim() != 2 or (ln_w is None) != (ln_b is None):
        raise ValueError(f"row_quantize: h {tuple(h.shape)} with ln_w and ln_b both or "
                         "neither: need (M, K)")
    if h.device.type == "cpu":
        return row_quantize_reference(h, ln_w, ln_b, ln_eps)
    M, K = h.shape
    if not row_quantize_takes(K):
        raise ValueError(f"row_quantize: K={K}: the kernel takes rows of at most {ROW_MAX} "
                         "values")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"row_quantize: h has dtype {h.dtype}: bf16 or fp32")
    Kp = rowpad.aligned(K)
    if Kp != K:  # rows padded with zeros, the LayerNorm told their width
        pad = torch.nn.functional.pad
        h = pad(h, (0, Kp - K))
        ln_w, ln_b = (None, None) if ln_w is None else (pad(ln_w, (0, Kp - K)),
                                                         pad(ln_b, (0, Kp - K)))
    dev, f32 = h.device, torch.float32
    codes = torch.empty((M, Kp), dtype=torch.int8, device=dev)
    scales = torch.empty((M,), dtype=f32, device=dev)
    err = _cuda.library().d2s_rowq(
        _cuda.ptr(h, "h", dev, h.dtype, (M, Kp)), int(h.dtype == f32),
        _cuda.ptr(ln_w, "ln_w", dev, f32, (Kp,)), _cuda.ptr(ln_b, "ln_b", dev, f32, (Kp,)),
        float(ln_eps), codes.data_ptr(), scales.data_ptr(), M, Kp, K, _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_rowq")
    row_quantize.launches += 1
    if Kp != K:
        return rowpad.count("row_quantize", codes[:, :K].contiguous()), scales
    return codes, scales


row_quantize.launches = 0


def int_dot(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """q (..., K) int8 times wq (N, K) int8 over K, exactly: float64 holds
    every partial sum (|sum| <= K * 127^2, far under 2^53)."""
    return torch.matmul(q.double(), wq.double().t())


def dequantize(acc: torch.Tensor, row_s: torch.Tensor, col_s: torch.Tensor, bias):
    """acc * (row_scale * col_scale) + bias, in fp32 (acc rounded to fp32
    first, as an int32 accumulator is converted)."""
    out = acc.float() * (row_s * col_s.float())
    return out if bias is None else out + bias.float()


def qmatmul(h32: torch.Tensor, wq: torch.Tensor, col_s: torch.Tensor, bias) -> torch.Tensor:
    """quantize_rows(h32) times the int8 weight (out, in), dequantized, plus
    bias: fp32 (..., out)."""
    q, s = quantize_rows(h32)
    return dequantize(int_dot(q, wq), s, col_s, bias)


def qgemm_reference(codes, row_s, w_q, col_s, bias=None, residual=None, gelu=False,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain torch version of `qgemm`: the exact product (`int_dot`),
    dequantized (`dequantize`), the exact GELU of its bf16 rounding, plus
    the residual in fp32, rounded once to out_dtype."""
    v = dequantize(int_dot(codes, w_q), row_s[:, None], col_s, bias)
    if gelu:
        v = F.gelu(v.to(torch.bfloat16).float())
    if residual is not None:
        v = residual.float() + v
    return v.to(out_dtype)


def _qgemm_check(codes, row_s, w_q, col_s, bias, residual, out_dtype):
    """Raise on what neither `qgemm` version takes."""
    if codes.dim() != 2 or w_q.dim() != 2 or codes.shape[1] != w_q.shape[1]:
        raise ValueError(f"qgemm: codes {tuple(codes.shape)} and w_q {tuple(w_q.shape)}: need "
                         "(M, K) and (N, K)")
    if codes.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"qgemm: codes {codes.dtype}, w_q {w_q.dtype}: need int8")
    (M, _), N = codes.shape, w_q.shape[0]
    vectors = (("row_s", row_s, (M,)), ("col_s", col_s, (N,)), ("bias", bias, (N,)))
    for name, t, shape in vectors[:3 if bias is not None else 2]:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"qgemm: {name} {t.dtype} {tuple(t.shape)}: need fp32 {shape}")
    if residual is not None and (residual.dtype not in (torch.bfloat16, torch.float32)
                                 or tuple(residual.shape) != (M, N)):
        raise ValueError(f"qgemm: residual {residual.dtype} {tuple(residual.shape)}: need bf16 "
                         f"or fp32 {(M, N)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qgemm: out_dtype {out_dtype}: bf16 or fp32")


def qgemm(codes, row_s, w_q, col_s, bias=None, residual=None, gelu=False,
          out_dtype=torch.bfloat16) -> torch.Tensor:
    """One int8 product of the W8A8 block, (M, N) in out_dtype:
    residual + act(acc * (row_s * col_s) + bias), acc the exact sum over K of
    codes (M, K) int8 times w_q (N, K) int8 (the torch Linear layout), row_s
    (M,) and col_s (N,) fp32, bias (N,) fp32 or None, residual (M, N) bf16
    or fp32 or None, act the exact GELU of the bf16-rounded value where
    `gelu`; each operation rounded on its own, then one rounding to
    out_dtype (bf16 or fp32). A CUDA tensor launches the GEMM engine's int8
    kernel (K that is no multiple of 16 and N that is no multiple of 8
    padded with zero codes, `ops.rowpad`); a CPU tensor runs
    `qgemm_reference`. Launches count in `qgemm.launches`."""
    _qgemm_check(codes, row_s, w_q, col_s, bias, residual, out_dtype)
    if codes.device.type == "cpu":
        return qgemm_reference(codes, row_s, w_q, col_s, bias, residual, gelu, out_dtype)
    (M, K), N = codes.shape, w_q.shape[0]
    Kp, Np = rowpad.aligned(K, rowpad.INT8_QUANTUM), rowpad.aligned(N)
    if (Kp, Np) != (K, N):  # zero codes and scales past K and N
        pad = torch.nn.functional.pad
        out = qgemm(pad(codes, (0, Kp - K)), row_s, pad(w_q, (0, Kp - K, 0, Np - N)),
                    pad(col_s, (0, Np - N)), None if bias is None else pad(bias, (0, Np - N)),
                    None if residual is None else pad(residual, (0, Np - N)), gelu, out_dtype)
        return rowpad.count("qgemm", out[:, :N].contiguous())
    dev, i8, f32 = codes.device, torch.int8, torch.float32
    res_bf16 = residual if residual is not None and residual.dtype == torch.bfloat16 else None
    res_f32 = residual if residual is not None and residual.dtype == f32 else None
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    f32_out = out_dtype == f32
    err = _cuda.library().d2s_qgemm(
        _cuda.ptr(codes, "codes", dev, i8, (M, K)), _cuda.ptr(row_s, "row_s", dev, f32, (M,)),
        _cuda.ptr(w_q, "w_q", dev, i8, (N, K)), _cuda.ptr(col_s, "col_s", dev, f32, (N,)),
        _cuda.ptr(bias, "bias", dev, f32, (N,)),
        _cuda.ptr(res_bf16, "residual", dev, torch.bfloat16, (M, N)),
        _cuda.ptr(res_f32, "residual", dev, f32, (M, N)),
        0 if f32_out else out.data_ptr(), out.data_ptr() if f32_out else 0,
        M, N, K, int(gelu), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_qgemm")
    qgemm.launches += 1
    return out


qgemm.launches = 0


def layer_norm_f32(h32: torch.Tensor, weight, bias, eps: float, width=None) -> torch.Tensor:
    """LayerNorm of fp32 rows in fp32, as the JAX block writes it: two-pass
    mean and variance, (h - mean) * rsqrt(var + eps) * weight + bias. With
    `width` (less than the rows'), over the first `width` columns, zeros
    past them (`ops.block.layer_norm`'s rule)."""
    n = h32.shape[-1]
    if width is not None and width < n:
        y = layer_norm_f32(h32[..., :width], weight[:width], bias[:width], eps)
        return F.pad(y, (0, n - width))
    mu = h32.mean(dim=-1, keepdim=True)
    d = h32 - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * weight.float() + bias.float()


def quant_block_reference(x: torch.Tensor, qw: dict, num_heads: int, scale: float,
                          ln_eps: float, *, stages: bool = False, ln_width=None):
    """Plain torch version of the int8 block, (B, N, C) in the compute dtype
    -> the same. `qw`: `quantize_block_params` of the block's weights. With
    `stages`, returns (out, stages) where stages holds each quantization's
    input, codes and scales ("h1", "q1", "s1" for LN1(x), 2 for the
    attention output, 3 for LN2(x_mid), 4 for the GELU activation) and the
    intermediates "qkv", "attn", "mid" (fp32) and "act". `ln_width`: the
    LayerNorms' width where x's rows end in zero columns (`ops.rowpad`)."""
    dtype = x.dtype
    x32 = x.float()
    st = {}

    def qmm(i, h32, wq, col_s, bias):
        q, s = quantize_rows(h32)
        st[f"h{i}"], st[f"q{i}"], st[f"s{i}"] = h32, q, s[..., 0]
        return dequantize(int_dot(q, wq), s, col_s, bias)

    h1 = layer_norm_f32(x32, qw["ln1_w"], qw["ln1_b"], ln_eps, ln_width)
    qkv = qmm(1, h1, qw["wqkv_q"], qw["sqkv"], qw["bqkv"]).to(dtype)
    attn = attention_reference(qkv, num_heads, scale)
    mid = x32 + qmm(2, attn.float(), qw["wproj_q"], qw["sproj"], qw["bproj"])
    h3 = layer_norm_f32(mid, qw["ln2_w"], qw["ln2_b"], ln_eps, ln_width)
    y = qmm(3, h3, qw["w1_q"], qw["s1"], qw["b1"])
    act = F.gelu(y.to(dtype).float()).to(dtype)
    out = (mid + qmm(4, act.float(), qw["w2_q"], qw["s2"], qw["b2"])).to(dtype)
    if stages:
        st.update(qkv=qkv, attn=attn, mid=mid, act=act)
        return out, st
    return out


def _int8_shapes(C: int, hidden: int) -> dict:
    i8, f32 = torch.int8, torch.float32
    return {
        "ln1_w": (f32, (C,)), "ln1_b": (f32, (C,)),
        "wqkv_q": (i8, (3 * C, C)), "sqkv": (f32, (3 * C,)), "bqkv": (f32, (3 * C,)),
        "wproj_q": (i8, (C, C)), "sproj": (f32, (C,)), "bproj": (f32, (C,)),
        "ln2_w": (f32, (C,)), "ln2_b": (f32, (C,)),
        "w1_q": (i8, (hidden, C)), "s1": (f32, (hidden,)), "b1": (f32, (hidden,)),
        "w2_q": (i8, (C, hidden)), "s2": (f32, (C,)), "b2": (f32, (C,)),
    }


def _launch_int8(x, qw, num_heads, scale, ln_eps, stages=False):
    """One d2s_block_int8_forward call: out, or (out, stages) with the four
    quantizations' codes "q1".."q4" and row scales "s1".."s4" and the
    intermediates "qkv", "attn", "mid" (fp32) and "act"; rows whose widths
    are no multiples of 16 padded (`ops.rowpad`)."""
    what = "fused_transformer_block_int8"
    C = x.shape[2]
    head_width(C, num_heads, what)
    hidden = qw["w1_q"].shape[0]
    check_rows(C, hidden, what)
    L = rowpad.block_layout(C, num_heads, hidden, rowpad.INT8_QUANTUM)
    if L is None:
        return _kernel_int8(x, qw, num_heads, scale, ln_eps, C, stages)
    return rowpad.count(what, padded_int8(x, qw, L, lambda xp, qwp: _kernel_int8(
        xp, qwp, num_heads, scale, ln_eps, L.C, stages), stages))


def padded_int8(x, qw, layout, kernel, stages=False):
    """The int8 block at `layout`'s padded widths: `kernel(xp, qwp)` -> out
    (or (out, stages)) on the padded rows and weights (zero codes, scales
    and LayerNorm parameters in the padding), unpadded."""
    got = kernel(rowpad.pad(x, layout, "C"), rowpad.pad_weights(qw, layout))
    if not stages:
        return rowpad.unpad(got, layout, "C")
    return rowpad.unpad(got[0], layout, "C"), rowpad.unpad_stages(got[1], layout)


def _kernel_int8(x, qw, num_heads, scale, ln_eps, ln_c, stages):
    what = "fused_transformer_block_int8"
    B, N, C = x.shape
    d = head_width(C, num_heads, what)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x is on {x.device}: need a CUDA or CPU tensor")
    check_tokens(N, d, what)
    hidden = qw["w1_q"].shape[0]
    check_rows(C, hidden, what)
    dev, bf16, f32, i8 = x.device, torch.bfloat16, torch.float32, torch.int8
    shapes = _int8_shapes(C, hidden)
    ptrs = [_cuda.ptr(qw[k], k, dev, *shapes[k]) for k in INT8_WEIGHT_KEYS]
    x_ptr = _cuda.ptr(x, "x", dev, bf16, (B, N, C))
    out = torch.empty_like(x)
    qkv = torch.empty((B, N, 3 * C), dtype=bf16, device=dev)
    attn = torch.empty_like(x)
    mid = torch.empty((B, N, C), dtype=f32, device=dev)
    act = torch.empty((B, N, hidden), dtype=bf16, device=dev)
    if stages:
        codes = [torch.empty((B, N, k), dtype=i8, device=dev) for k in (C, C, C, hidden)]
        scales = [torch.empty((B, N), dtype=f32, device=dev) for _ in range(4)]
    else:  # each quantization is read by the next kernel only: one buffer
        codes = [torch.empty((B * N * max(C, hidden),), dtype=i8, device=dev)] * 4
        scales = [torch.empty((B * N,), dtype=f32, device=dev)] * 4
    err = _cuda.library().d2s_block_int8_forward(
        x_ptr, out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), mid.data_ptr(),
        act.data_ptr(), *(c.data_ptr() for c in codes), *(s.data_ptr() for s in scales),
        *ptrs, B, N, C, num_heads, hidden, ln_c, float(scale), float(ln_eps),
        _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_block_int8_forward")
    fused_transformer_block_int8.launches += 1
    if not stages:
        return out
    st = {f"q{i + 1}": c for i, c in enumerate(codes)}
    st.update({f"s{i + 1}": s for i, s in enumerate(scales)})
    st.update(qkv=qkv, attn=attn, mid=mid, act=act)
    return out, st


_OP_KEYS = tuple(k for k in INT8_WEIGHT_KEYS if k != "bqkv")


@torch.library.custom_op("d2s::block_int8", mutates_args=(), device_types="cpu")
def _block_int8_op(x: torch.Tensor, weights: List[torch.Tensor], bqkv: Optional[torch.Tensor],
                   num_heads: int, scale: float, ln_eps: float) -> torch.Tensor:
    qw = dict(zip(_OP_KEYS, weights), bqkv=bqkv)
    return quant_block_reference(x, qw, num_heads, scale, ln_eps)


@_block_int8_op.register_kernel("cuda")
def _(x, weights, bqkv, num_heads, scale, ln_eps):
    return _launch_int8(x, dict(zip(_OP_KEYS, weights), bqkv=bqkv), num_heads, scale, ln_eps)


@_block_int8_op.register_fake
def _(x, weights, bqkv, num_heads, scale, ln_eps):
    return torch.empty_like(x)


def fused_transformer_block_int8(
    x: torch.Tensor,
    qw: dict,
    num_heads: int,
    *,
    scale: float | None = None,
    ln_eps: float = 1e-6,
    stages: bool = False,
):
    """One whole pre-norm block with int8 projections, policy-free,
    (B, N, C) -> (B, N, C) in x's dtype. `qw`: `quantize_block_params` of
    the block's compute-dtype weights. With `stages`, returns (out, stages):
    the kernel's intermediates (see `_launch_int8`; on the CPU those of
    `quant_block_reference`). It has no gradient: under autograd it raises.
    Launches count in `launches`; the eager call goes through the
    `d2s::block_int8` op, so that `torch.export` records it."""
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, C), got {tuple(x.shape)}")
    if scale is None:
        scale = (x.shape[2] // num_heads) ** -0.5
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_transformer_block_int8 has no gradient: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.device.type != "cpu":
        head_width(x.shape[2], num_heads, "fused_transformer_block_int8")
    if stages:
        if x.device.type == "cpu":
            return quant_block_reference(x, qw, num_heads, scale, ln_eps, stages=True)
        return _launch_int8(x, qw, num_heads, scale, ln_eps, stages=True)
    return torch.ops.d2s.block_int8(x, [qw[k] for k in _OP_KEYS], qw["bqkv"], num_heads,
                                    float(scale), float(ln_eps))


fused_transformer_block_int8.launches = 0
