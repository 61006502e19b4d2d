"""The LayerNorm backward and the bias column sums of the block backward
(`dense2sparse_vit_torch/ops/norm.py`), on the CPU.

`ln_backward_reference` against `jax.vjp` of the JAX block's LayerNorm
formula (`dense2sparse_vit_tpu/ops/pallas/attention.py::
_ref_attention_block`'s, the one the block kernels fold into their
projections, `block.py:52-63`), with a residual in bf16, in fp32 or none;
`column_sums_reference` and the weight gradient's folded bias sums against
numpy. The wrappers run these plain versions for CPU tensors. fp32; each
test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_torch.ops.gemm as gemm_ops
import dense2sparse_vit_torch.ops.norm as norm_ops
from dense2sparse_vit_torch import ops

EPS = 1e-6


def _jax_layer_norm(x, scale, bias):
    """The JAX block's LayerNorm in fp32: E[x^2] - mu^2 variance."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(x * x, axis=-1, keepdims=True) - mu * mu
    return (x - mu) * jax.lax.rsqrt(var + EPS) * scale + bias


def _inputs(m, c, res, seed):
    """x (bf16 values), dy, gamma, beta and a residual, as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, c), dtype=np.float32) * 2 + 0.5)
    x = x.to(torch.bfloat16).float().numpy()
    dy = rng.standard_normal((m, c), dtype=np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    r = None if res is None else torch.from_numpy(
        rng.standard_normal((m, c), dtype=np.float32)).to(res).float().numpy()
    return x, dy, gamma, beta, r


@pytest.mark.parametrize("res", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(8, 128), (96, 128), (8, 384), (96, 384)])
def test_ln_backward_reference_matches_jax_vjp(m, c, res):
    """dx (the fp32 copy; the bf16 dx is its rounding), d_ln_w and d_ln_b
    within 1e-5 of each one's largest magnitude: the JAX formula's row
    statistics handed to the port, fp32 on both sides in other orders."""
    x, dy, gamma, beta, r = _inputs(m, c, res, seed=m + c)
    y, vjp = jax.vjp(_jax_layer_norm, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want_dx, want_dw, want_db = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    if r is not None:
        want_dx = want_dx + r
    mu = x.mean(-1, dtype=np.float64)
    var = (x.astype(np.float64) ** 2).mean(-1) - mu ** 2
    stats = torch.from_numpy(np.stack([mu, 1 / np.sqrt(var + EPS)], -1).astype(np.float32))
    residual = None if r is None else torch.from_numpy(r).to(res)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    dx, dx_f, dw, db = norm_ops.ln_backward(torch.from_numpy(dy), xt, stats,
                                            torch.from_numpy(gamma), residual, fp32_copy=True)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, dx_f.to(torch.bfloat16))
    for got, want in ((dx_f, want_dx), (dw, want_dw), (db, want_db)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    two = norm_ops.ln_backward(torch.from_numpy(dy), xt, stats, torch.from_numpy(gamma), residual)
    assert len(two) == 3 and all(torch.equal(a, b) for a, b in zip(two, (dx, dw, db)))


def test_ln_stats_are_the_rows_mean_and_inverse_std():
    x, *_ = _inputs(40, 384, None, seed=1)
    st = norm_ops.ln_stats(torch.from_numpy(x).to(torch.bfloat16), EPS)
    np.testing.assert_allclose(st[:, 0].numpy(), x.mean(-1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st[:, 1].numpy(), 1 / np.sqrt(x.var(-1) + EPS), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", [(1, 8), (96, 384), (77, 1152)])
def test_column_sums_reference_matches_numpy(m, n, dtype):
    """Each column within 1e-6 of the sum of its terms' magnitudes (fp32
    against numpy's float64)."""
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(dtype)
    want = a.float().numpy().astype(np.float64).sum(0)
    got = norm_ops.column_sums(a)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, norm_ops.column_sums_reference(a))
    bound = 1e-6 * np.abs(a.float().numpy()).astype(np.float64).sum(0)
    assert (np.abs(got.numpy() - want) <= bound).all()


@pytest.mark.parametrize("m,i,j", [(1, 8, 16), (96, 384, 64), (70, 24, 40)])
def test_weight_grad_reference_with_bias_sums_p_columns(m, i, j):
    """weight_grad(p, q, bias=True) on the CPU: P^T Q and P's column sums in
    fp32 (within 1e-5 of numpy's float64, relative to the sums of the
    terms' magnitudes), dW the product without them."""
    rng = np.random.default_rng(m + i)
    p = torch.from_numpy(rng.standard_normal((m, i), dtype=np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((m, j), dtype=np.float32)).to(torch.bfloat16)
    dw, db = gemm_ops.weight_grad(p, q, bias=True)
    assert torch.equal(dw, gemm_ops.weight_grad(p, q))
    pn = p.float().numpy().astype(np.float64)
    assert (np.abs(db.numpy() - pn.sum(0)) <= 1e-5 * np.abs(pn).sum(0)).all()


def test_launch_counts_stay_zero_without_the_kernels_library():
    """The two counts live in the kernels' library: 0 until it is loaded
    (never on the CPU), and resetting them does not build it."""
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["ln_bwd"] == 0 and counts["column_sums"] == 0
    x, dy, gamma, *_ = _inputs(8, 128, None, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    norm_ops.ln_backward(torch.from_numpy(dy), xt, norm_ops.ln_stats(xt, EPS),
                         torch.from_numpy(gamma))
    assert norm_ops.LN_BWD.launches == 0 and norm_ops.COLUMN_SUMS.launches == 0
