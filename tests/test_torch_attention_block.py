"""Port parity of the attention half-block, x + proj(MHA(qkv(LN1 x))):
dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The forward (plain, policy mode at eps 1e-6 and 0.1, the CLS rows, no qkv
bias), the backward in both modes (all seven or eight outputs) and the
autograd Function's gradients, at B=2, N in {13, 20}, C=128, 2 heads (the
kernels' head_dim 64), fp32 on the CPU. The same inputs, drawn with numpy
from fixed seeds, go through the JAX function (its Pallas kernels in
interpret mode) and the port's counterpart, which runs its plain torch
version for CPU tensors. Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention

from dense2sparse_vit_torch.ops.attention import (
    fused_attention_block,
    fused_attention_block_backward,
    fused_attention_block_backward_policy,
    fused_attention_block_trainable,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, C, H = 2, 128, 2
NAMES = ("ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj")


def _inputs(n, seed=50, bqkv=True):
    """x and the six weights in JAX's layout ((in, out) matrices), fp32."""
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    x = r(B, n, C)
    w = {"ln_w": 1 + r(C, s=0.1), "ln_b": r(C, s=0.1), "wqkv": r(C, 3 * C, s=C ** -0.5),
         "bqkv": r(3 * C, s=0.1), "wproj": r(C, C, s=C ** -0.5), "bproj": r(C, s=0.1)}
    if not bqkv:
        w["bqkv"] = np.zeros_like(w["bqkv"])
    return x, w


def _keep_policy(n, seed=51):
    pol = (np.random.default_rng(seed).random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return pol


def _port(w, bqkv=True):
    """The weights as the port takes them: matrices (out, in)."""
    out = [torch.from_numpy(np.ascontiguousarray(w[k].T if w[k].ndim == 2 else w[k]))
           for k in NAMES]
    if not bqkv:
        out[3] = None
    return out


def _jax(w):
    return [jnp.asarray(w[k]) for k in NAMES]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = {
    "plain": dict(),
    "policy": dict(policy=True, eps=1e-6),
    "policy_eps0.1": dict(policy=True, eps=0.1),
    "cls": dict(cls=True),
    "cls_policy": dict(cls=True, policy=True, eps=0.1),
    "no_bqkv": dict(bqkv=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [13, 20])
def test_forward_matches_pallas_and_reference(n, case):
    """Output (and CLS rows) within rtol = atol = 1e-5 of the Pallas kernel
    (exact softmax, interpret mode) and, where it takes the case, of
    `_ref_attention_block` (fp32; the TPU kernel folds LN1 into the qkv
    weights and pads N to 16, which reorders the sums)."""
    kw = CASES[case]
    bqkv = kw.get("bqkv", True)
    x, w = _inputs(n, bqkv=bqkv)
    pol = _keep_policy(n) if kw.get("policy") else None
    eps, cls = kw.get("eps", 1e-6), kw.get("cls", False)
    want = jax_attention.fused_attention_block(
        jnp.asarray(x), *_jax(w), H, _j(pol), eps=eps, return_cls=cls, exact=True,
        interpret=True)
    got = fused_attention_block(_t(x), *_port(w, bqkv), H, _t(pol), eps=eps, return_cls=cls)
    if cls:
        (want, want_cls), (got, got_cls) = want, got
        assert got_cls.shape == (B, H, n)
        np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_cls.sum(-1).numpy(), 1.0, atol=1e-5)
    assert got.shape == (B, n, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if eps == 1e-6 and not cls:  # the JAX reference has no eps and no CLS rows
        ref = jax_attention._ref_attention_block(
            jnp.asarray(x), *_jax(w), H, _j(pol), None, 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _jax_layout(name, grad):
    """A port gradient in JAX's layout: matrices (in, out)."""
    grad = grad.numpy()
    return grad.T if name in ("wqkv", "wproj") else grad


def _close_to_max(got, want, rel=1e-4):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("policy,eps", [(False, 1e-6), (True, 1e-6), (True, 0.1)])
def test_backward_matches_pallas(policy, eps):
    """All seven outputs (dx, dln_w, dln_b, dwqkv, dbqkv, dwproj, dbproj),
    and dPolicy in policy mode, within 1e-4 of each tensor's largest
    magnitude (fp32 sums over the batch in another order)."""
    n = 20
    x, w = _inputs(n, seed=52)
    g = np.random.default_rng(53).standard_normal((B, n, C)).astype(np.float32)
    wj, wt = _jax(w), _port(w)
    if policy:
        pol = _keep_policy(n, seed=54)
        want = jax_attention.fused_attention_block_backward_policy(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(pol), *wj[:5], H, eps=eps,
            interpret=True)
        got = fused_attention_block_backward_policy(_t(x), _t(g), _t(pol), *wt[:5], H, eps=eps)
        assert len(got) == 8
    else:
        want = jax_attention.fused_attention_block_backward(
            jnp.asarray(x), jnp.asarray(g), *wj[:5], H, interpret=True)
        got = fused_attention_block_backward(_t(x), _t(g), *wt[:5], H)
        assert len(got) == 7
    names = ["dx"] + (["dpolicy"] if policy else []) + list(NAMES)
    for name, a, b in zip(names, got, want):
        _close_to_max(_jax_layout(name, a), b)


def _jax_trainable_interpret():
    """JAX's custom VJP with its Pallas kernels in interpret mode."""
    saved = {k: getattr(jax_attention, k) for k in (
        "fused_attention_block", "fused_attention_block_backward",
        "fused_attention_block_backward_policy")}
    for k, fn in saved.items():
        setattr(jax_attention, k, functools.partial(fn, interpret=True))
    return saved


@pytest.mark.parametrize("policy", [False, True])
def test_trainable_gradients_match_jax_vjp(policy):
    """The autograd Function's output and gradients (x, the six weights and,
    in policy mode, the policy) against `jax.vjp` of
    `fused_attention_block_trainable`, within 1e-4 of each tensor's largest
    magnitude; the output within 1e-5."""
    n = 13
    x, w = _inputs(n, seed=55)
    g = np.random.default_rng(56).standard_normal((B, n, C)).astype(np.float32)
    pol = _keep_policy(n, seed=57) if policy else None
    saved = _jax_trainable_interpret()
    try:
        def f(xx, *args):
            *ws, p = args
            return jax_attention.fused_attention_block_trainable(xx, *ws, H, p)

        want_out, vjp = jax.vjp(f, jnp.asarray(x), *_jax(w), _j(pol))
        want = vjp(jnp.asarray(g))
    finally:
        for k, fn in saved.items():
            setattr(jax_attention, k, fn)
    leaves = [t.requires_grad_() for t in [_t(x), *_port(w)]]
    pt = _t(pol).requires_grad_() if policy else None
    out = fused_attention_block_trainable(leaves[0], *leaves[1:], H, pt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, leaves + ([pt] if policy else []), _t(g))
    assert len(got) == len(want) - (0 if policy else 1)
    for name, a, b in zip(("dx",) + NAMES + ("dpolicy",), got, want):
        _close_to_max(_jax_layout(name, a), b)
