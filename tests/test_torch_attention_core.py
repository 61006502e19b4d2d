"""Port parity of the attention core's backward on the entry that launches
it alone besides the forward recompute: dense2sparse_vit_torch vs
dense2sparse_vit_tpu.

`ops.attention.fused_attention_backward_packed` (on a card the forward core
recomputed, then `attention_bwd_kernel`, then dPolicy's head sum) at a
small size: B=2, C=128, 2 heads (the kernels' head_dim 64), N = 17 and 80
(two of the kernel's 64-key blocks, the last one short), fp32 on the CPU,
where it runs its plain version. The same inputs, drawn with numpy from
fixed seeds, go through the JAX package's `fused_attention_backward_packed`
(its Pallas kernels in interpret mode). Each test states its tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
from dense2sparse_vit_torch.ops.attention import fused_attention_backward_packed

B, C, H = 2, 128, 2


def _inputs(n, seed=50):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, n, 3 * C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    gcls = rng.standard_normal((B, H, n)).astype(np.float32)
    pol = (rng.random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return qkv, g, gcls, pol


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_gcls", [False, True])
@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("n", [17, 80])
def test_core_backward_matches_pallas(n, policy, with_gcls):
    """dqkv, and dPolicy in policy mode: within 1e-4 of each tensor's
    largest magnitude (fp32 sums in another order)."""
    qkv, g, gcls, pol = _inputs(n)
    gcls = gcls if with_gcls else None
    pol = pol if policy else None
    want = jax_attention.fused_attention_backward_packed(
        _j(qkv), _j(g), H, policy=_j(pol), gcls=_j(gcls), interpret=True)
    got = fused_attention_backward_packed(_t(qkv), _t(g), H, policy=_t(pol), gcls=_t(gcls))
    pairs = zip(got, want) if policy else [(got, want)]
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())
