"""Port parity of the block's policy mode: dense2sparse_vit_torch vs
dense2sparse_vit_tpu.

`softmax_with_policy` and `threshold_keep_mask`, then the block in policy
mode both ways: the forward and its CLS rows against the Pallas kernel
(interpret mode) and `_ref_block`; the backward (dx, the twelve gradients,
dPolicy) against the Pallas backward kernel and `jax.vjp` of `_ref_block`.
Each runs at the model's eps = 1e-6 and at eps = 0.1, where the eps/N
smoothing and the max path's gradient are large enough to see, and once
with exact ties at a row's max (duplicated key rows), whose gradient JAX
splits evenly. `_ref_block` has no eps argument: at eps = 0.1 the test
hands it `softmax_with_policy` with that eps for the duration of the call.
fp32 on the CPU; each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.masked_softmax as jax_masked_softmax
import dense2sparse_vit_tpu.ops.pallas.block as jax_block
from dense2sparse_vit_tpu.ops.topk import threshold_keep_mask as jax_threshold_keep_mask

from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.ops.block import (
    attention_reference,
    fused_transformer_block,
    fused_transformer_block_backward,
    fused_transformer_block_cls,
    fused_transformer_block_trainable,
)
from dense2sparse_vit_torch.ops.masked_softmax import softmax_with_policy
from dense2sparse_vit_torch.ops.topk import threshold_keep_mask
from test_torch_ops import _block_params, _port_block_state, load_numpy_state
from test_torch_train import BLOCK_KEYS

BN, BC, BH = 13, 64, 2
EPS = (1e-6, 0.1)
# (eps, ties): every eps on random tokens, and duplicated key rows at 0.1
CASES = [(1e-6, False), (0.1, False), (0.1, True)]
PORT_KEYS = {  # JAX fused-block params key -> the port's block-weights key
    "ln1_scale": "ln1_w", "ln1_bias": "ln1_b", "wqkv": "wqkv", "bqkv": "bqkv",
    "wproj": "wproj", "bproj": "bproj", "ln2_scale": "ln2_w", "ln2_bias": "ln2_b",
    "w1": "w1", "b1": "b1", "w2": "w2", "b2": "b2",
}


# ---- softmax_with_policy and threshold_keep_mask --------------------------


def _policy(rng, b, n):
    pol = (rng.random((b, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return pol


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("ties", [False, True])
def test_softmax_with_policy_matches_jax(eps, ties):
    """Values and the VJP (scores and policy) within 1e-6; with ties, rows
    whose max is reached by several columns, where the max path's gradient
    is split among them."""
    rng = np.random.default_rng(40)
    s = rng.standard_normal((2, 2, 9, 9)).astype(np.float32)
    if ties:
        s[:, :, :, 4] = s[:, :, :, 2] = s.max(-1) + 0.5  # an exact two-way tie at the max
    pol = _policy(rng, 2, 9)
    g = rng.standard_normal(s.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, p: jax_masked_softmax.softmax_with_policy(a, p, eps),
                        jnp.asarray(s), jnp.asarray(pol))
    want_ds, want_dp = vjp(jnp.asarray(g))
    st = torch.from_numpy(s).requires_grad_()
    pt = torch.from_numpy(pol).requires_grad_()
    got = softmax_with_policy(st, pt, eps)
    got_ds, got_dp = torch.autograd.grad(got, (st, pt), torch.from_numpy(g))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_ds.numpy(), np.asarray(want_ds), **tol)
    np.testing.assert_allclose(got_dp.numpy(), np.asarray(want_dp), **tol)
    if ties:  # both tied columns take half the max path's gradient
        assert not np.allclose(got_ds.numpy()[..., 2], 0.0)


def test_threshold_keep_mask_matches_jax():
    """Mask exact, keep ratios within 1e-7. XLA's cumsum and torch's may
    round differently, so no prefix sum of these scores lies within 1e-5 of
    the threshold (checked here), and ties between scores are included to
    pin the stable sort."""
    rng = np.random.default_rng(41)
    scores = rng.dirichlet(np.ones(20), size=6).astype(np.float32)
    scores[0, 3] = scores[0, 7]  # ties sort by index in both
    for thr in (0.1, 0.5, 0.9):
        prefix = np.cumsum(np.sort(scores, axis=-1), axis=-1)
        assert np.abs(prefix - thr).min() > 1e-5
        want_mask, want_ratio = jax_threshold_keep_mask(jnp.asarray(scores), thr)
        mask, ratio = threshold_keep_mask(torch.from_numpy(scores), thr)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_allclose(ratio.numpy(), np.asarray(want_ratio), rtol=1e-7)
        assert mask.dtype == torch.float32


# ---- the block in policy mode ---------------------------------------------


def _case(ties, seed=42):
    """Block params, x, the cotangent g and a (B, N) keep policy. With ties,
    tokens 2, 6 and 10 are copies of token 4 (so their key rows are equal);
    token 6's copy is dropped by the policy."""
    p = _block_params(BC, 4 * BC, seed=24)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, BN, BC)).astype(np.float32)
    if ties:
        x[:, [2, 6, 10]] = x[:, [4]]
    g = rng.standard_normal((2, BN, BC)).astype(np.float32)
    pol = _policy(rng, 2, BN)
    if ties:
        pol[:, 6] = 0.0
    return p, x, g, pol


def _port_weights(p):
    return {PORT_KEYS[k]: torch.from_numpy(np.array(v.T if v.ndim == 2 else v))
            for k, v in p.items()}


def _with_eps(eps, fn):
    """fn() with the JAX package's softmax_with_policy at smoothing `eps`
    (the reference `_ref_block` calls it with the default)."""
    real = jax_masked_softmax.softmax_with_policy
    jax_masked_softmax.softmax_with_policy = functools.partial(real, eps=eps)
    try:
        return fn()
    finally:
        jax_masked_softmax.softmax_with_policy = real


def _tied_rows(p, x, pol):
    """How many (sample, head, query) rows reach their max at two or more
    columns, in the port's fp32 scores."""
    w = _port_weights(p)
    from dense2sparse_vit_torch.ops.block import layer_norm, linear
    qkv = linear(layer_norm(torch.from_numpy(x), w["ln1_w"], w["ln1_b"], 1e-6), w["wqkv"],
                 w["bqkv"])
    q, k, _ = qkv.view(2, BN, 3, BH, BC // BH).permute(2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q, k.transpose(-1, -2)) * (BC // BH) ** -0.5
    return int(((s == s.amax(-1, keepdim=True)).sum(-1) > 1).sum())


@pytest.mark.parametrize("eps,ties", CASES)
def test_policy_block_forward_and_cls_rows_match_jax(eps, ties):
    """The block output within 2e-4 (the TPU kernel folds LayerNorm into the
    weights, which reorders fp32 sums) and the (B, H, N) CLS rows within
    1e-5, against the Pallas kernel and, for the output, `_ref_block`."""
    p, x, _, pol = _case(ties)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out_k, cls_k = jax_block.fused_transformer_block(
        jnp.asarray(x), jp, BH, jnp.asarray(pol), eps=eps, return_cls=True, exact=True,
        interpret=True)
    out_r = _with_eps(eps, lambda: jax_block._ref_block(
        jnp.asarray(x), jp, BH, jnp.asarray(pol), None, 1e-6))
    w, xt, pt = _port_weights(p), torch.from_numpy(x), torch.from_numpy(pol)
    out = fused_transformer_block(xt, w, BH, pt, eps=eps)
    out_c, cls = fused_transformer_block_cls(xt, w, BH, pt, eps=eps)
    assert torch.equal(out, out_c) and cls.shape == (2, BH, BN)
    for want in (out_k, out_r):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_k), rtol=1e-4, atol=1e-5)
    # the smoothing puts eps/N / den on every dropped column of the CLS row
    dropped = pol[:, None, :].repeat(BH, 1) == 0
    assert (cls.numpy()[dropped] > 0).all()
    if ties:
        assert _tied_rows(p, x, pol) > 0


@pytest.mark.parametrize("eps,ties", CASES)
def test_policy_block_backward_matches_jax(eps, ties):
    """dx, the twelve gradients and dPolicy within 2e-4 (as the forward),
    each relative to its tensor's largest magnitude, against the Pallas
    backward kernel and `jax.vjp` of `_ref_block`; without dPolicy the rest
    is the same."""
    p, x, g, pol = _case(ties, seed=43)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, BH, jnp.asarray(pol), eps=eps, interpret=True)

    def ref_vjp():
        _, vjp = jax.vjp(lambda a, q, b: jax_block._ref_block(a, q, BH, b, None, 1e-6),
                         jnp.asarray(x), jp, jnp.asarray(pol))
        return vjp(jnp.asarray(g))

    dx_r, dp_r, dpol_r = _with_eps(eps, ref_vjp)
    w = _port_weights(p)
    dx, dw, dpol = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), w, BH, torch.from_numpy(pol), eps=eps)
    for want_dx, want_dp, want_dpol in ((dx_k, dp_k, dpol_k), (dx_r, dp_r, dpol_r)):
        pairs = [("dx", dx, want_dx), ("dpolicy", dpol, want_dpol)]
        pairs += [(k, dw[PORT_KEYS[k]], want_dp[k]) for k in BLOCK_KEYS]
        for name, got, want in pairs:
            want = np.asarray(want)
            want = want.T if name in ("wqkv", "wproj", "w1", "w2") else want
            scale = np.abs(want).max()
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * scale,
                                       err_msg=name)
    dx2, dw2, none = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), w, BH, torch.from_numpy(pol), eps=eps,
        policy_grad=False)
    assert none is None and torch.equal(dx2, dx)
    assert all(torch.equal(dw2[k], dw[k]) for k in dw)
    if ties:
        assert _tied_rows(p, x, pol) > 0


def test_dpolicy_leaves_the_diagonal_out():
    """dPolicy_j sums de_ij exp(s_ij - m_i) over the queries i != j only: a
    policy entry does not touch its own row's diagonal, which is always
    kept. With one token, dPolicy is therefore zero."""
    p, x, g, pol = _case(False)
    w = _port_weights(p)
    _, _, dpol = fused_transformer_block_backward(
        torch.from_numpy(x[:, :1]).contiguous(), torch.from_numpy(g[:, :1]).contiguous(), w, BH,
        torch.from_numpy(pol[:, :1]).contiguous(), eps=0.1)
    assert torch.equal(dpol, torch.zeros_like(dpol))


@pytest.mark.parametrize("use_fused", [True, False])
def test_block_with_policy_trains_like_the_kernel_pair(use_fused):
    """The Block's policy path in train mode: the fused dispatch
    (`fused_transformer_block_trainable`, whose backward is
    `fused_transformer_block_backward`) and the plain layers give the same
    output, the same gradients and the same dPolicy (in the policy's dtype)
    within 1e-5."""
    p, x, g, pol = _case(False, seed=44)
    blk = load_numpy_state(Block(BC, BH, use_fused=use_fused), _port_block_state(p)).train()
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pol).requires_grad_()
    out = blk(xt, pt)
    out.backward(torch.from_numpy(g))
    w = _port_weights(p)
    want_out = fused_transformer_block(torch.from_numpy(x), w, BH, torch.from_numpy(pol))
    want_dx, want_dw, want_dpol = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), w, BH, torch.from_numpy(pol))
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.detach(), want_out, **tol)
    torch.testing.assert_close(xt.grad, want_dx, **tol)
    torch.testing.assert_close(pt.grad, want_dpol, **tol)
    params = dict(blk.named_parameters())
    for jk, pk in BLOCK_KEYS.items():
        torch.testing.assert_close(params[pk].grad, want_dw[PORT_KEYS[jk]], **tol)


@pytest.mark.parametrize("needs_grad", [False, True])
def test_trainable_block_asks_for_dpolicy_only_when_needed(monkeypatch, needs_grad):
    """A policy without a gradient (threshold mode's, from stopped scores)
    makes the backward skip dPolicy; one with a gradient (the gumbel
    decisions) gets it back in its own dtype."""
    import dense2sparse_vit_torch.ops.block as block_ops

    seen = []
    real = block_ops.fused_transformer_block_backward
    monkeypatch.setattr(block_ops, "fused_transformer_block_backward",
                        lambda *a, **k: seen.append(k["policy_grad"]) or real(*a, **k))
    p, x, g, pol = _case(False, seed=46)
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pol).to(torch.float64).requires_grad_(needs_grad)
    out = fused_transformer_block_trainable(xt, _port_weights(p), BH, pt)
    out.backward(torch.from_numpy(g))
    assert seen == [needs_grad]
    assert (pt.grad is not None) == needs_grad
    if needs_grad:
        assert pt.grad.dtype == torch.float64


def test_attention_reference_cls_row_is_the_policy_softmax():
    rng = np.random.default_rng(45)
    qkv = torch.from_numpy(rng.standard_normal((2, BN, 3 * BC)).astype(np.float32))
    pol = torch.from_numpy(_policy(rng, 2, BN))
    out, cls = attention_reference(qkv, BH, 0.2, policy=pol, eps=0.1, return_cls=True)
    torch.testing.assert_close(cls.sum(-1), torch.ones((2, BH)), rtol=0, atol=1e-6)
    assert out.shape == (2, BN, BC)
