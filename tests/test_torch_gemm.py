"""The shared GEMM engine's plain version (`ops/gemm.py`) against numpy.

On the CPU `ln_gemm` and `weight_grad` run their plain versions, which the
card's tests (`tests/test_torch_cuda.py`) hold the kernel against; here
each is held against the same function written in numpy in float64, on
float32 inputs (no bf16 rounding on either side), within 1e-5 of the
output's largest magnitude: fp32 sums over K <= 96 terms.
"""

import math

import numpy as np
import pytest
import torch

from dense2sparse_vit_torch.ops.gemm import ln_gemm, weight_grad

TOL = 1e-5
# (option name, M rows as samples x rows, N, K)
OPTIONS = ("plain", "ln_gelu_preact", "residual_scaled", "gelu_grad_f32", "relu_bias")


def _erf(x):
    return np.vectorize(math.erf)(x)


def _numpy_ln_gemm(a, w, w_kn, bias=None, ln=None, act="none", gelu_in=None, row_scale=None,
                   residual=None):
    x = a.reshape(-1, a.shape[-1]).astype(np.float64)
    if ln is not None:
        ln_w, ln_b, eps = ln
        mu = x.mean(-1, keepdims=True)
        x = (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + eps) * ln_w + ln_b
    v = x @ (w if w_kn else w.T).astype(np.float64)
    if bias is not None:
        v = v + bias
    pre = v.copy()
    if act == "gelu":
        v = 0.5 * v * (1 + _erf(v / np.sqrt(2)))
    elif act == "relu":
        v = np.maximum(v, 0)
    if gelu_in is not None:
        u = gelu_in.astype(np.float64)
        v = v * (0.5 * (1 + _erf(u / np.sqrt(2))) + u * np.exp(-0.5 * u * u) / np.sqrt(2 * np.pi))
    if row_scale is not None:
        v = v * np.repeat(row_scale, v.shape[0] // row_scale.shape[0])[:, None]
    if residual is not None:
        v = v + residual
    return v, pre


def _close(got, want):
    got = got.detach().numpy().astype(np.float64)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("w_kn", [False, True])
@pytest.mark.parametrize("option", OPTIONS)
def test_ln_gemm_plain_version_against_numpy(option, w_kn, strided):
    rng = np.random.default_rng(OPTIONS.index(option) + 10 * w_kn + 20 * strided)
    S, R, N, K = 3, 7, 24, 96
    f = np.float32
    # a strided (S, R, K) view: the rows after each sample's first, as x[:, 1:]
    full = rng.standard_normal((S, R + 1, K)).astype(f)
    a_np = full[:, 1:] if strided else full[:, 1:].reshape(S * R, K).copy()
    w_np = (rng.standard_normal((K, N) if w_kn else (N, K)) / np.sqrt(K)).astype(f)
    kw, np_kw = {}, {}
    M = S * R
    if option == "ln_gelu_preact":
        ln_w = (1 + 0.1 * rng.standard_normal(K)).astype(f)
        ln_b = (0.1 * rng.standard_normal(K)).astype(f)
        bias = rng.standard_normal(N).astype(f)
        np_kw = {"ln": (ln_w, ln_b, 1e-6), "bias": bias, "act": "gelu"}
        kw = {"ln": (torch.from_numpy(ln_w), torch.from_numpy(ln_b), 1e-6),
              "bias": torch.from_numpy(bias), "act": "gelu", "preact": True}
    elif option == "residual_scaled":
        res = rng.standard_normal((M, N)).astype(f)
        s = rng.uniform(0.0, 2.0, S).astype(f)
        np_kw = {"residual": res, "row_scale": s}
        kw = {"residual": torch.from_numpy(res), "row_scale": torch.from_numpy(s)}
    elif option == "gelu_grad_f32":
        gi = rng.standard_normal((M, N)).astype(f)
        np_kw = {"gelu_in": gi}
        kw = {"gelu_in": torch.from_numpy(gi), "out_f32": True}
    elif option == "relu_bias":
        bias = rng.standard_normal(N).astype(f)
        np_kw = {"bias": bias, "act": "relu"}
        kw = {"bias": torch.from_numpy(bias), "act": "relu"}
    a = torch.from_numpy(full)[:, 1:] if strided else torch.from_numpy(a_np)
    got = ln_gemm(a, torch.from_numpy(w_np), w_kn=w_kn, **kw)
    want, pre = _numpy_ln_gemm(a_np, w_np, w_kn, **np_kw)
    if kw.get("preact"):
        got, got_pre = got
        _close(got_pre, pre)
    assert tuple(got.shape) == (M, N)
    _close(got, want)


@pytest.mark.parametrize("m,i,j", [(50, 16, 24), (7, 8, 40)])
def test_weight_grad_plain_version_against_numpy(m, i, j):
    rng = np.random.default_rng(m)
    p = rng.standard_normal((m, i)).astype(np.float32)
    q = rng.standard_normal((m, j)).astype(np.float32)
    got = weight_grad(torch.from_numpy(p), torch.from_numpy(q))
    _close(got, p.T.astype(np.float64) @ q.astype(np.float64))


def test_ln_gemm_rejects_an_unknown_activation():
    with pytest.raises(ValueError):
        ln_gemm(torch.zeros(2, 8), torch.zeros(8, 8), act="tanh")
