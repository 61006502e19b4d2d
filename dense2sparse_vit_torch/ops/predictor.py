"""PredictorLG forward, LayerNorm variants: (B, N, D) tokens -> (B, N) scores.

`fused_predictor_lg` is the port of
`dense2sparse_vit_tpu/ops/pallas/predictor.py::fused_predictor_lg`. For a
CUDA tensor it launches `csrc/predictor.cu`; for a CPU tensor it runs
`predictor_lg_reference`, the plain torch version. Both go through the
custom op `d2s::predictor_lg` (a `cuda` implementation that launches the
kernel and counts the launch, a `cpu` one that runs the plain version, and
a fake one for `torch.export`); on the CPU under autograd the wrapper calls
the differentiable plain version directly.

`predictor_lg_split_reference` is a second plain version, of the algebra
the kernel computes: the first output unit split into a per-token local
half and a per-sample rank-1 global half (the kernel's notes). Only tests
and `chip_smoke.py` call it.

Weights are a dict:
  units: [(ln_w, ln_b, weight, bias), ...] for the input units, then the
    output units, each LayerNorm -> Linear -> act; LayerNorm parameters and
    biases fp32, weights (out, in) in the compute dtype;
  n_in: how many of `units` come before the local/global split;
  final: (ln_w, ln_b, weight (1, c), bias (1,)), the last LayerNorm and the
    1-unit head;
  act: "gelu" (small predictor) or "relu" (large).
"""

from __future__ import annotations

import ctypes
from typing import List

import torch
import torch.nn.functional as F

from dense2sparse_vit_torch.ops import _cuda, rowpad
from dense2sparse_vit_torch.ops.block import layer_norm, linear

_ACTS = {"gelu": 1, "relu": 2}


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h.float()).to(h.dtype)
    return F.relu(h)


def local_global(h: torch.Tensor) -> torch.Tensor:
    """The predictor's local/global split: (B, N, c) with channels [c/2:]
    replaced by their mean over the tokens (in fp32, rounded to h.dtype)."""
    c2 = h.shape[-1] // 2
    glob = h[..., c2:].float().mean(dim=1, keepdim=True).to(h.dtype)
    return torch.cat([h[..., :c2], glob.expand(-1, h.shape[1], -1)], -1)


def predictor_lg_reference(x: torch.Tensor, w: dict, eps: float = 1e-5):
    """Plain torch version of `fused_predictor_lg`."""
    h = x
    for i, (ln_w, ln_b, weight, bias) in enumerate(w["units"]):
        h = _act(linear(layer_norm(h, ln_w, ln_b, eps), weight, bias), w["act"])
        if i == w["n_in"] - 1:
            h = local_global(h)
    ln_w, ln_b, weight, bias = w["final"]
    return linear(layer_norm(h, ln_w, ln_b, eps), weight, bias)[..., 0]


def predictor_lg_split_reference(x: torch.Tensor, w: dict, eps: float = 1e-5):
    """Plain torch version of the split form `csrc/predictor.cu` computes.

    The input units as in `predictor_lg_reference`; then, with c2 = c / 2,
    the pooled half g (each sample's mean of h[:, c2:], rounded to x.dtype)
    and the first output unit as
        out_0 = y @ W_top^T + r (t + (m_g - mu) u) + v
        y = ((h_local - mu) r ln_w_top + ln_b_top), rounded to x.dtype
        t = ((g - m_g) ln_w_bot) @ W_bot^T, u = ln_w_bot @ W_bot^T,
        v = ln_b_bot @ W_bot^T + b
    in fp32, where mu and r = 1/sqrt(var + eps) are the concat row's
    LayerNorm statistics, combined from the local half's mean and squared
    deviations and the sample's (m_g and the squared deviations of g about
    it); the remaining units and the final one as the plain version. With
    the split after the last unit there is no out_0, and the final unit
    runs on the concat row as in the plain version, which this returns.
    """
    units, n_in, act = w["units"], w["n_in"], w["act"]
    if n_in == len(units):
        return predictor_lg_reference(x, w, eps)
    dt = x.dtype
    h = x
    for ln_w, ln_b, weight, bias in units[:n_in]:
        h = _act(linear(layer_norm(h, ln_w, ln_b, eps), weight, bias), act)
    c = h.shape[-1]
    c2, cg = c // 2, c - c // 2
    loc = h[..., :c2].float()                                       # (B, N, c2)
    glob = h[..., c2:].float().mean(dim=1).to(dt).float()           # (B, cg)
    m_l = loc.mean(-1, keepdim=True)
    q_l = (loc - m_l).square().sum(-1, keepdim=True)
    m_g = glob.mean(-1, keepdim=True)[:, None]                      # (B, 1, 1)
    q_g = (glob - m_g[:, 0]).square().sum(-1, keepdim=True)[:, None]
    mu = (c2 * m_l + cg * m_g) / c
    var = (q_l + q_g + c2 * (m_l - mu).square() + cg * (m_g - mu).square()) / c
    r = torch.rsqrt(var + eps)
    ln_w, ln_b, weight, bias = (t.float() for t in units[n_in])
    w_top, w_bot = weight[:, :c2], weight[:, c2:]
    y = ((loc - mu) * r * ln_w[:c2] + ln_b[:c2]).to(dt).float()
    t = ((glob - m_g[:, 0]) * ln_w[c2:]) @ w_bot.t()                # (B, n0)
    u = ln_w[c2:] @ w_bot.t()
    v = ln_b[c2:] @ w_bot.t() + bias
    h = _act((y @ w_top.t() + r * (t[:, None] + (m_g - mu) * u) + v).to(dt), act)
    for ln_w, ln_b, weight, bias in units[n_in + 1:]:
        h = _act(linear(layer_norm(h, ln_w, ln_b, eps), weight, bias), act)
    ln_w, ln_b, weight, bias = w["final"]
    return linear(layer_norm(h, ln_w, ln_b, eps), weight, bias)[..., 0]


def _flat(w: dict) -> list:
    """The units' and the final unit's tensors, four each, in order."""
    return [t for unit in (*w["units"], w["final"]) for t in unit]


def _unflat(tensors, n_in: int, act: str) -> dict:
    units = [tuple(tensors[i:i + 4]) for i in range(0, len(tensors), 4)]
    return {"units": units[:-1], "n_in": n_in, "final": units[-1], "act": act}


@torch.library.custom_op("d2s::predictor_lg", mutates_args=(), device_types="cpu")
def _predictor_op(x: torch.Tensor, tensors: List[torch.Tensor], n_in: int, act: str,
                  eps: float) -> torch.Tensor:
    return predictor_lg_reference(x, _unflat(tensors, n_in, act), eps).contiguous()


@_predictor_op.register_fake
def _(x, tensors, n_in, act, eps):
    return x.new_empty(x.shape[:2])


@_predictor_op.register_kernel("cuda")
def _(x, tensors, n_in, act, eps):
    return _launch_predictor(x, _unflat(tensors, n_in, act), eps)


def fused_predictor_lg(x: torch.Tensor, w: dict, eps: float = 1e-5):
    """(B, N, D) spatial tokens -> (B, N) raw keep scores, in x.dtype.

    On the card, x's rows must be contiguous (stride(2) == 1,
    stride(1) == D); the sample stride is free, so the spatial view
    x[:, 1:] of the residual stream is read in place. Widths of any size:
    where D or a unit's input width is no multiple of 8, the kernel reads
    a copy whose rows lie at that width rounded up to 8 (`pitched`).
    """
    if x.dim() != 3:
        raise ValueError(f"expected x (B, N, D), got {tuple(x.shape)}")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in _flat(w)))
    if x.device.type == "cpu" and needs_grad:
        return predictor_lg_reference(x, w, eps)
    if needs_grad:
        raise RuntimeError("fused_predictor_lg has no backward kernel yet")
    return torch.ops.d2s.predictor_lg(x, _flat(w), w["n_in"], w["act"], float(eps))


def pitched(x: torch.Tensor, w: dict):
    """(x, w) as the kernel reads them: x's token rows, each unit's weight
    rows and the final unit's weight at a pitch of their width rounded up
    to 8, zeros past it (copies only where a width is no multiple of 8;
    `csrc/predictor.cu` reads the true widths and masks the rest)."""
    def at_pitch(t):
        n = t.shape[-1]
        return t if n % 8 == 0 else F.pad(t, (0, rowpad.aligned(n) - n))

    units = [(lw, lb, at_pitch(weight), bias) for lw, lb, weight, bias in w["units"]]
    flw, flb, fw, fb = w["final"]
    return at_pitch(x), {**w, "units": units, "final": (flw, flb, at_pitch(fw), fb)}


def _launch_predictor(x: torch.Tensor, w: dict, eps: float):
    B, N, D = x.shape
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    if x.dtype != bf16:
        raise TypeError(f"x has dtype {x.dtype}, expected {bf16}")
    if x.stride(2) != 1 or x.stride(1) != D:
        raise ValueError("x needs contiguous token rows")
    units, n_in, act = w["units"], w["n_in"], w["act"]
    if act not in _ACTS or not 1 <= n_in <= len(units):
        raise ValueError(f"act={act!r}, n_in={n_in} with {len(units)} units")
    widths = [weight.shape[0] for _, _, weight, _ in units]
    narrow = any(c % 8 for c in [D] + widths)
    if narrow:
        x, w = pitched(x, w)
        units = w["units"]
    if x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError("x needs 16-byte aligned token rows")
    ln_w, ln_b, mats, biases = [], [], [], []
    c_in = D
    for u, (lw, lb, weight, bias) in enumerate(units):
        c_out = widths[u]
        ln_w.append(_cuda.ptr(lw, f"units[{u}].ln_w", dev, f32, (c_in,)))
        ln_b.append(_cuda.ptr(lb, f"units[{u}].ln_b", dev, f32, (c_in,)))
        mats.append(_cuda.ptr(weight, f"units[{u}].weight", dev, bf16,
                              (c_out, rowpad.aligned(c_in))))
        biases.append(_cuda.ptr(bias, f"units[{u}].bias", dev, f32, (c_out,)))
        c_in = c_out
    flw, flb, fw, fb = w["final"]
    final = [
        _cuda.ptr(flw, "final.ln_w", dev, f32, (c_in,)),
        _cuda.ptr(flb, "final.ln_b", dev, f32, (c_in,)),
        _cuda.ptr(fw, "final.weight", dev, bf16, (1, rowpad.aligned(c_in))),
        _cuda.ptr(fb, "final.bias", dev, f32, (1,)),
    ]
    n = len(units)
    lib = _cuda.library()
    c_widths = (ctypes.c_int * n)(*widths)
    nbytes = lib.d2s_predictor_scratch_bytes(B, N, D, n, n_in, c_widths)
    if nbytes < 0:
        raise ValueError(f"fused_predictor_lg does not take B={B}, N={N}, D={D}, widths={widths}")
    scores = torch.empty((B, N), dtype=bf16, device=dev)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    arr = ctypes.c_void_p * n
    err = lib.d2s_predictor_forward(
        x.data_ptr(), x.stride(0), scores.data_ptr(), scratch.data_ptr(), nbytes, B, N, D, n,
        n_in, c_widths, arr(*ln_w), arr(*ln_b), arr(*mats), arr(*biases), *final,
        _ACTS[act], float(eps), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_predictor_forward")
    fused_predictor_lg.launches += 1
    if narrow:
        rowpad.count("fused_predictor_lg")
    return scores


fused_predictor_lg.launches = 0
