"""Port parity at head widths other than 64: dense2sparse_vit_torch vs
dense2sparse_vit_tpu.

The JAX Pallas kernels take any head width (`block.py:226`, `:753`); the
port's kernels take every width from 1 to 256 (`ops.block.head_width`),
64 on their wgmma cores and the others on csrc/attention_hd.cuh's path. On
the CPU each wrapper runs its plain version, which is what these tests hold
against the Pallas kernels in interpret mode, at d = 12 and 96 (2 heads, C
= 24 and 192), B = 2, N = 13 and 24, on numpy inputs from a seed: the block
forward in plain, policy and CLS-row mode, its backward with dPolicy, the
packed attention both ways (with the CLS fold), the half-block forward and
the int8 block. Tolerance TOL (1e-5, fp32 sums in another order: the TPU
kernels fold LN1 into the weights and pad N to 16), relative to the
largest magnitude compared; the int8 block within one code step, as
`test_torch_quant.py` holds it. A last test holds
the wrappers to refusing a width past 256 before they touch the device (odd
widths and widths past 128: `test_torch_head_width_odd_wide.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
import dense2sparse_vit_tpu.ops.pallas.block as jax_block
import dense2sparse_vit_tpu.ops.pallas.quant as jax_quant

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.ops.quant import quant_block_reference, quantize_block_params
from test_torch_ops import _block_params
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, H = 2, 2
WIDTHS = (12, 96)
TOL = 1e-5
_KEYS = {"ln1_scale": "ln1_w", "ln1_bias": "ln1_b", "wqkv": "wqkv", "bqkv": "bqkv",
         "wproj": "wproj", "bproj": "bproj", "ln2_scale": "ln2_w", "ln2_bias": "ln2_b",
         "w1": "w1", "b1": "b1", "w2": "w2", "b2": "b2"}


def _case(d, n, seed=0):
    """(JAX block params, the port's weight dict, x, g, keep policy, gcls)
    at head width d: C = 2 d, hidden 3 C."""
    C = H * d
    p = _block_params(C, 3 * C, seed=seed + d)
    w = {_KEYS[k]: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
         for k, v in p.items()}
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    pol = (rng.random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    gcls = rng.standard_normal((B, H, n)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, w, x, g, pol, gcls


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("n", [13, 24])
@pytest.mark.parametrize("mode", ["plain", "policy", "cls"])
def test_block_forward_matches_pallas(d, n, mode):
    """The block's output (and in "cls" mode its CLS rows, in policy mode
    at eps 0.1) against `fused_transformer_block` in interpret mode."""
    jp, w, x, _, pol, _ = _case(d, n)
    pol = pol if mode == "policy" else None
    jpol = None if pol is None else jnp.asarray(pol)
    tp = None if pol is None else torch.from_numpy(pol)
    if mode == "cls":
        want, want_cls = jax_block.fused_transformer_block(jnp.asarray(x), jp, H,
                                                           return_cls=True, interpret=True)
        got, got_cls = ops.fused_transformer_block_cls(torch.from_numpy(x), w, H)
        _close(got_cls, want_cls, TOL)
    else:
        want = jax_block.fused_transformer_block(jnp.asarray(x), jp, H, jpol, eps=0.1,
                                                 interpret=True)
        got = ops.fused_transformer_block(torch.from_numpy(x), w, H, tp, eps=0.1)
    _close(got, want, TOL)


@pytest.mark.parametrize("d", WIDTHS)
def test_block_backward_with_dpolicy_matches_pallas(d):
    """dx, the twelve gradients and dPolicy (eps 0.1) against
    `fused_transformer_block_backward` in interpret mode."""
    jp, w, x, g, pol, _ = _case(d, 24, seed=1)
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, H, jnp.asarray(pol), eps=0.1, interpret=True)
    dx, dw, dpol = ops.fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), w, H, torch.from_numpy(pol), eps=0.1)
    _close(dx, dx_k, TOL)
    _close(dpol, dpol_k, TOL)
    for jk, pk in _KEYS.items():
        want = np.asarray(dp_k[jk])
        _close(dw[pk], want.T if want.ndim == 2 else want, TOL)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("policy", [False, True])
def test_packed_attention_both_ways_match_pallas(d, policy):
    """The packed core's output and CLS rows, then dqkv (and dPolicy) with
    the CLS rows' cotangent folded in, against the Pallas kernels."""
    C = H * d
    rng = np.random.default_rng(d)
    qkv = rng.standard_normal((B, 24, 3 * C)).astype(np.float32)
    _, _, _, g, pol, gcls = _case(d, 24, seed=2)
    pol = pol if policy else None
    jpol = None if pol is None else jnp.asarray(pol)
    tp = None if pol is None else torch.from_numpy(pol)
    want, want_cls = jax_attention.fused_attention_packed(
        jnp.asarray(qkv), H, jpol, eps=0.1, return_cls=True, exact=True, interpret=True)
    got, got_cls = ops.fused_attention_packed(torch.from_numpy(qkv), H, tp, eps=0.1,
                                              return_cls=True)
    _close(got, want, TOL)
    _close(got_cls, want_cls, TOL)
    want = jax_attention.fused_attention_backward_packed(
        jnp.asarray(qkv), jnp.asarray(g), H, policy=jpol, gcls=jnp.asarray(gcls), eps=0.1,
        interpret=True)
    got = ops.fused_attention_backward_packed(torch.from_numpy(qkv), torch.from_numpy(g), H,
                                              policy=tp, gcls=torch.from_numpy(gcls), eps=0.1)
    for a, b in (zip(got, want) if policy else [(got, want)]):
        _close(a, b, TOL)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("policy", [False, True])
def test_half_block_forward_matches_pallas(d, policy):
    """x + proj(MHA(qkv(LN1 x))) and its CLS rows against
    `fused_attention_block` (exact softmax) in interpret mode."""
    jp, w, x, _, pol, _ = _case(d, 13, seed=3)
    pol = pol if policy else None
    names = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj")
    want, want_cls = jax_attention.fused_attention_block(
        jnp.asarray(x), *(jp[k] for k in names), H, None if pol is None else jnp.asarray(pol),
        eps=0.1, return_cls=True, exact=True, interpret=True)
    got, got_cls = ops.fused_attention_block(
        torch.from_numpy(x), *(w[_KEYS[k]] for k in names), H,
        None if pol is None else torch.from_numpy(pol), eps=0.1, return_cls=True)
    _close(got, want, TOL)
    _close(got_cls, want_cls, TOL)


@pytest.mark.parametrize("d", WIDTHS)
def test_int8_block_matches_pallas(d):
    """The plain int8 block against `fused_transformer_block_int8` in
    interpret mode, within one code step of the last product (the most a
    single flipped code moves an output element)."""
    jp, w, x, _, _, _ = _case(d, 24, seed=4)
    want = jax_quant.fused_transformer_block_int8(jnp.asarray(x), jp, H, block_batch=2,
                                                  interpret=True)
    qw = quantize_block_params(w)
    got, st = quant_block_reference(torch.from_numpy(x), qw, H, d ** -0.5, 1e-6, stages=True)
    step = st["s4"].max().item() * 127 * qw["s2"].max().item()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=step)


@pytest.mark.parametrize("C,width", [(514, "257"), (768, "384")])
def test_wrappers_refuse_widths_the_kernels_do_not_take(C, width):
    """Every kernel wrapper raises ValueError naming the head width (past
    256) and the ceiling before it touches the device: on tensors on the
    meta device, which hold no data, the wrappers' checks are all that
    runs."""
    meta = torch.device("meta")
    x = torch.empty((B, 13, C), device=meta, dtype=torch.bfloat16)
    qkv = torch.empty((B, 13, 3 * C), device=meta, dtype=torch.bfloat16)
    hidden = 4 * C
    w = {"ln1_w": (C,), "ln1_b": (C,), "wqkv": (3 * C, C), "bqkv": (3 * C,),
         "wproj": (C, C), "bproj": (C,), "ln2_w": (C,), "ln2_b": (C,), "w1": (hidden, C),
         "b1": (hidden,), "w2": (C, hidden), "b2": (C,)}
    w = {k: torch.empty(s, device=meta) for k, s in w.items()}
    w6 = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")]
    calls = [
        lambda: ops.fused_transformer_block(x, w, H),
        lambda: ops.fused_transformer_block_cls(x, w, H),
        lambda: ops.fused_transformer_block_backward(x, x, w, H),
        lambda: ops.fused_attention_packed(qkv, H),
        lambda: ops.fused_attention_backward_packed(qkv, x, H),
        lambda: ops.fused_attention_block(x, *w6, H),
        lambda: ops.fused_attention_block_backward(x, x, *w6[:5], H),
        lambda: ops.fused_transformer_block_int8(x, {}, H),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=f"head width {width} .* from 1 to 256"):
            call()
