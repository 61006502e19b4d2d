"""PredictorLG forward, LayerNorm variants: (B, N, D) tokens -> (B, N) scores.

`fused_predictor_lg` is the port of
`dense2sparse_vit_tpu/ops/pallas/predictor.py::fused_predictor_lg`. For a
CUDA tensor it launches `csrc/predictor.cu`; for a CPU tensor it runs
`predictor_lg_reference`, the plain torch version. Both go through the
custom op `d2s::predictor_lg` (a `cuda` implementation that launches the
kernel and counts the launch, a `cpu` one that runs the plain version, and
a fake one for `torch.export`); on the CPU under autograd the wrapper calls
the differentiable plain version directly.

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

from dense2sparse_vit_torch.ops import _cuda
from dense2sparse_vit_torch.ops.block import layer_norm, linear

_ACTS = {"gelu": 1, "relu": 2}


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h.float()).to(h.dtype)
    return F.relu(h)


def predictor_lg_reference(x: torch.Tensor, w: dict, eps: float = 1e-5):
    """Plain torch version of `fused_predictor_lg`."""
    h = x
    for i, (ln_w, ln_b, weight, bias) in enumerate(w["units"]):
        h = _act(linear(layer_norm(h, ln_w, ln_b, eps), weight, bias), w["act"])
        if i == w["n_in"] - 1:
            # local/global split: channels [c/2:] become the per-sample mean
            c2 = h.shape[-1] // 2
            glob = h[..., c2:].float().mean(dim=1, keepdim=True).to(h.dtype)
            h = torch.cat([h[..., :c2], glob.expand(-1, h.shape[1], -1)], -1)
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
    x[:, 1:] of the residual stream is read in place.
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


def _launch_predictor(x: torch.Tensor, w: dict, eps: float):
    B, N, D = x.shape
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    if x.dtype != bf16:
        raise TypeError(f"x has dtype {x.dtype}, expected {bf16}")
    if x.stride(2) != 1 or x.stride(1) != D or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError("x needs contiguous, 16-byte aligned token rows")
    units, n_in, act = w["units"], w["n_in"], w["act"]
    if act not in _ACTS or not 1 <= n_in <= len(units):
        raise ValueError(f"act={act!r}, n_in={n_in} with {len(units)} units")
    widths, ln_w, ln_b, mats, biases = [], [], [], [], []
    c_in = D
    for u, (lw, lb, weight, bias) in enumerate(units):
        c_out = weight.shape[0]
        if c_in % 8 or c_out % 8:
            raise ValueError(f"unit {u}: widths {c_in}->{c_out}: need multiples of 8")
        ln_w.append(_cuda.ptr(lw, f"units[{u}].ln_w", dev, f32, (c_in,)))
        ln_b.append(_cuda.ptr(lb, f"units[{u}].ln_b", dev, f32, (c_in,)))
        mats.append(_cuda.ptr(weight, f"units[{u}].weight", dev, bf16, (c_out, c_in)))
        biases.append(_cuda.ptr(bias, f"units[{u}].bias", dev, f32, (c_out,)))
        widths.append(c_out)
        c_in = c_out
    flw, flb, fw, fb = w["final"]
    final = [
        _cuda.ptr(flw, "final.ln_w", dev, f32, (c_in,)),
        _cuda.ptr(flb, "final.ln_b", dev, f32, (c_in,)),
        _cuda.ptr(fw, "final.weight", dev, bf16, (1, c_in)),
        _cuda.ptr(fb, "final.bias", dev, f32, (1,)),
    ]
    n = len(units)
    scores = torch.empty((B, N), dtype=bf16, device=dev)
    buf0 = torch.empty((B * N * max(widths),), dtype=bf16, device=dev)
    buf1 = torch.empty_like(buf0)
    stats = torch.empty((B * N, 2), dtype=f32, device=dev)
    arr = ctypes.c_void_p * n
    err = _cuda.library().d2s_predictor_forward(
        x.data_ptr(), x.stride(0), scores.data_ptr(), buf0.data_ptr(),
        buf1.data_ptr(), stats.data_ptr(), B, N, D, n, n_in, (ctypes.c_int * n)(*widths),
        arr(*ln_w), arr(*ln_b), arr(*mats), arr(*biases), *final,
        _ACTS[act], float(eps), _cuda.stream_handle(dev),
    )
    _cuda.check(err, "d2s_predictor_forward")
    fused_predictor_lg.launches += 1
    return scores


fused_predictor_lg.launches = 0
