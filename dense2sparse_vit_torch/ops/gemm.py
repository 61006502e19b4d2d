"""The block kernels' shared bf16 GEMM engine, as entries of its own.

`csrc/ln_gemm.cuh` computes every projection inside the block kernels (the
TPU kernels' `jnp.dot`s on the MXU); it replaces no TPU kernel of its own.
These two entries run it alone, so that it can be held against its plain
version and timed at the block kernels' shapes:

- `ln_gemm`: out = epi(LN(a) W), with the engine's options: a LayerNorm
  prologue, the weight in the torch Linear layout (N, K) or in (K, N),
  and the epilogue bias, then the `preact` copy (v + bias, rounded to
  a.dtype), then the activation (exact GELU or ReLU), then times
  GELU'(gelu_in), then a per-sample row scale, then the residual, then one
  rounding (or none, with `out_f32`);
- `weight_grad`: dW = P^T Q in fp32, P (M, I), Q (M, J), the backward's
  weight gradient, its M rows split across the card and summed in a fixed
  order; with `bias=True` also db = P's column sums in fp32 (the bias
  gradient of a layer whose output's cotangent is P), summed from the
  product's own reads of P.

For CUDA tensors they launch `csrc/gemm.cu` (`d2s_ln_gemm`, `d2s_wgrad`);
for CPU tensors they run `ln_gemm_reference` and `weight_grad_reference`:
LayerNorm, then the product in fp32, then the epilogue, then one rounding.
The engine's TMA maps take rows of 16-byte multiples; widths that are no
multiple of 8 go to it padded with zero columns (the LayerNorm told its true
width) and come back sliced (`ops.rowpad`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda, rowpad

_ACTS = {"none": 0, "gelu": 1, "relu": 2}


def _gelu_grad(v: torch.Tensor) -> torch.Tensor:
    """d/dv of the exact GELU, in fp32."""
    v = v.float()
    return 0.5 * (1.0 + torch.erf(v * 0.5 ** 0.5)) + v * torch.exp(-0.5 * v * v) / math.sqrt(
        2.0 * math.pi)


def _rows(a: torch.Tensor) -> torch.Tensor:
    """a's rows as one (M, K) matrix (a copy for a strided 3-D view)."""
    return a.reshape(-1, a.shape[-1])


def ln_gemm_reference(a, w, *, w_kn=False, bias=None, ln=None, act="none", gelu_in=None,
                      row_scale=None, residual=None, preact=False, out_f32=False):
    """Plain torch version of `ln_gemm`: (out (M, N)[, preact (M, N)])."""
    x = _rows(a)
    if ln is not None:
        ln_w, ln_b, eps = ln
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + eps)
        x = ((xf - mu) * rstd * ln_w.float() + ln_b.float()).to(a.dtype)
    v = x.float() @ (w.float() if w_kn else w.float().t())
    if bias is not None:
        v = v + bias.float()
    pre = v.to(a.dtype) if preact else None
    if act == "gelu":
        v = F.gelu(v)
    elif act == "relu":
        v = v.clamp(min=0)
    if gelu_in is not None:
        v = v * _gelu_grad(gelu_in)
    if row_scale is not None:
        v = v * row_scale.float().repeat_interleave(v.shape[0] // row_scale.shape[0])[:, None]
    if residual is not None:
        v = v + residual.float()
    out = v if out_f32 else v.to(a.dtype)
    return (out, pre) if preact else out


def weight_grad_reference(p: torch.Tensor, q: torch.Tensor, bias: bool = False):
    """Plain torch version of `weight_grad`: P^T Q in fp32 (and P's column
    sums in fp32 with `bias`)."""
    dw = p.float().t() @ q.float()
    return (dw, p.float().sum(0)) if bias else dw


def _a_layout(a: torch.Tensor, K: int):
    """(rows per sample, elements between samples) of `a`, (M, K) or a
    (samples, rows, K) view whose rows lie K apart."""
    if a.dim() == 2:
        if not a.is_contiguous():
            raise ValueError("ln_gemm: a 2-D `a` must be contiguous")
        return a.shape[0], 0
    if a.dim() != 3 or a.stride(2) != 1 or a.stride(1) != K:
        raise ValueError(f"ln_gemm: a {tuple(a.shape)} with strides {a.stride()}: need "
                         "(M, K), or (samples, rows, K) with rows K apart")
    if a.shape[0] > 1 and a.stride(0) % 8:
        raise ValueError("ln_gemm: samples must lie a multiple of 8 elements apart")
    return a.shape[1], a.stride(0)


def ln_gemm(a, w, *, w_kn=False, bias=None, ln=None, act="none", gelu_in=None,
            row_scale=None, residual=None, preact=False, out_f32=False):
    """out (M, N) = epi(LN(a) W) over a's M rows (module docstring).

    a: (M, K), or (samples, rows, K) with rows K apart (a strided view such
    as x[:, 1:]); w: (N, K), or (K, N) with `w_kn`; bias (N,) fp32; ln:
    (ln_w (K,) fp32, ln_b (K,) fp32, eps) or None; act: "none", "gelu" or
    "relu"; gelu_in, residual: (M, N) in a's dtype; row_scale: (G,) fp32,
    one scale for each of G equal groups of rows (per sample); preact: also
    return v + bias in a's dtype; out_f32: the output in fp32. Launches
    count in `ln_gemm.launches`."""
    K = a.shape[-1]
    N = w.shape[1] if w_kn else w.shape[0]
    M = math.prod(a.shape[:-1])
    if act not in _ACTS:
        raise ValueError(f"act={act!r}: one of {sorted(_ACTS)}")
    if a.device.type == "cpu":
        return ln_gemm_reference(a, w, w_kn=w_kn, bias=bias, ln=ln, act=act, gelu_in=gelu_in,
                                 row_scale=row_scale, residual=residual, preact=preact,
                                 out_f32=out_f32)
    dev, bf16, f32 = a.device, torch.bfloat16, torch.float32
    if a.dtype != bf16:
        raise TypeError(f"ln_gemm: a has dtype {a.dtype}, the kernel takes bf16")
    Kp, Np = rowpad.aligned(K), rowpad.aligned(N)
    if (Kp, Np) != (K, N):  # zero columns past K and N (ops.rowpad)
        dk, dn = Kp - K, Np - N
        padn = (lambda t: None if t is None else F.pad(t, (0, dn)))
        wp = F.pad(w, (0, dn, 0, dk) if w_kn else (0, dk, 0, dn))
        lnp = None if ln is None else (F.pad(ln[0], (0, dk)), F.pad(ln[1], (0, dk)), ln[2])
        got = rowpad.count("ln_gemm", _ln_gemm(
            F.pad(a, (0, dk)), wp, w_kn, padn(bias), lnp, K, act, padn(gelu_in), row_scale,
            padn(residual), preact, out_f32))
        return tuple(t[:, :N].contiguous() for t in got) if preact else got[:, :N].contiguous()
    return _ln_gemm(a, w, w_kn, bias, ln, K, act, gelu_in, row_scale, residual, preact, out_f32)


def _ln_gemm(a, w, w_kn, bias, ln, ln_k, act, gelu_in, row_scale, residual, preact, out_f32):
    """One d2s_ln_gemm call at widths the engine takes."""
    K = a.shape[-1]
    N = w.shape[1] if w_kn else w.shape[0]
    M = math.prod(a.shape[:-1])
    dev, bf16, f32 = a.device, torch.bfloat16, torch.float32
    if a.data_ptr() % 16:
        raise ValueError("ln_gemm: a must be 16-byte aligned")
    a_rows, a_bstride = _a_layout(a, K)
    if row_scale is not None and (row_scale.dim() != 1 or M % row_scale.shape[0]):
        raise ValueError(f"ln_gemm: row_scale {tuple(row_scale.shape)} for {M} rows")
    ln_w, ln_b, eps = ln if ln is not None else (None, None, 0.0)
    stats = torch.empty((M, 2), dtype=f32, device=dev) if ln is not None else None
    out = torch.empty((M, N), dtype=f32 if out_f32 else bf16, device=dev)
    pre = torch.empty((M, N), dtype=bf16, device=dev) if preact else None
    err = _cuda.library().d2s_ln_gemm(
        a.data_ptr(), a_rows, a_bstride,
        _cuda.ptr(w, "w", dev, bf16, (K, N) if w_kn else (N, K)), int(w_kn),
        _cuda.ptr(bias, "bias", dev, f32, (N,)), _cuda.ptr(ln_w, "ln_w", dev, f32, (K,)),
        _cuda.ptr(ln_b, "ln_b", dev, f32, (K,)), float(eps), ln_k,
        0 if stats is None else stats.data_ptr(),
        _cuda.ptr(residual, "residual", dev, bf16, (M, N)),
        _cuda.ptr(row_scale, "row_scale", dev, f32, tuple(getattr(row_scale, "shape", ()))),
        M // row_scale.shape[0] if row_scale is not None else 0,
        _cuda.ptr(gelu_in, "gelu_in", dev, bf16, (M, N)),
        0 if pre is None else pre.data_ptr(),
        0 if out_f32 else out.data_ptr(), out.data_ptr() if out_f32 else 0,
        M, N, K, _ACTS[act], _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_ln_gemm")
    ln_gemm.launches += 1
    return (out, pre) if preact else out


def weight_grad(p: torch.Tensor, q: torch.Tensor, bias: bool = False):
    """dW (I, J) fp32 = P^T Q for P (M, I), Q (M, J) in bf16; with `bias`,
    (dW, db) with db (I,) fp32 = P's column sums. Launches count in
    `weight_grad.launches`."""
    if p.dim() != 2 or q.dim() != 2 or p.shape[0] != q.shape[0]:
        raise ValueError(f"weight_grad: P {tuple(p.shape)} and Q {tuple(q.shape)}: need "
                         "(M, I) and (M, J)")
    if p.device.type == "cpu":
        return weight_grad_reference(p, q, bias)
    (M, I), J = p.shape, q.shape[1]
    dev, bf16 = p.device, torch.bfloat16
    Ip, Jp = rowpad.aligned(I), rowpad.aligned(J)
    if (Ip, Jp) != (I, J):  # zero columns past I and J (ops.rowpad)
        got = rowpad.count("weight_grad",
                           weight_grad(F.pad(p, (0, Ip - I)), F.pad(q, (0, Jp - J)), bias))
        if bias:
            return got[0][:I, :J].contiguous(), got[1][:I]
        return got[:I, :J].contiguous()
    p_ptr = _cuda.ptr(p, "p", dev, bf16, (M, I))
    q_ptr = _cuda.ptr(q, "q", dev, bf16, (M, J))
    lib = _cuda.library()
    work = torch.empty((lib.d2s_wgrad_workspace_bytes(M, I, J),), dtype=torch.uint8, device=dev)
    dw = torch.empty((I, J), dtype=torch.float32, device=dev)
    db = torch.empty((I,), dtype=torch.float32, device=dev) if bias else None
    err = lib.d2s_wgrad(p_ptr, q_ptr, dw.data_ptr(), 0 if db is None else db.data_ptr(),
                        work.data_ptr(), M, I, J, _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_wgrad")
    weight_grad.launches += 1
    return (dw, db) if bias else dw


ln_gemm.launches = 0
weight_grad.launches = 0
