"""Port parity of the attention variants v1-v3 at every head width, row width
and sequence length JAX's `scripts/attn_variants.py::run_variant` takes.

JAX's `run_variant` takes C = H d for every d from 1 to 127, odd or even,
any N (padded to 16) and any B; v2 takes heads in pairs. The port's
`ops.fused_attention_variant` takes the same on the card (rows and heads
padded by `ops.rowpad` where C is no multiple of 8), up to the half-block's
forward ceiling `ops.block.attention_max_tokens(d)`, and refuses d >= 128,
where JAX's kernel fails (its `av` pads V with 128 - d ones columns).

- The port's `scripts/attn_variants.py::run_variant` (its plain versions,
  fp32) against JAX's (loaded by path, Pallas in interpret mode) on the same
  numpy inputs from a seed, at heads of 13 (C = 78, 6 heads), 12 (C = 24,
  2), 127 (C = 254, 2), 16 at N = 40, and an odd C (39, 3 heads of 13, v1
  and v3): within rtol = atol = 1e-5, as `test_torch_attn_variants.py`
  holds the script's own shape. The TPU variants' exp(clip(s, -30, 30))
  agrees with the port's exact softmax: every scaled logit here is far
  inside +-30.
- The padded route the card takes at C % 8 != 0 (`ops.attention.
  variant_route`), with the plain version at the padded widths standing in
  for the kernel (the LayerNorm over the true width, the scale of the true
  d): its output and stages equal the unpadded plain version's within fp32
  rounding.
- The rule `attention_variant_supported` and the wrapper's checks
  (`check_variant_shape`), without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense2sparse_vit_torch.ops import rowpad
from dense2sparse_vit_torch.ops.attention import (
    ATTN_BLOCK_KEYS,
    VARIANT_MAX_HEAD_DIM,
    VARIANTS,
    attention_variant_reference,
    attention_variant_supported,
    check_variant_shape,
    variant_route,
)
from dense2sparse_vit_torch.ops.block import attention_max_tokens
from dense2sparse_vit_torch.scripts import attn_variants
from test_torch_attn_variants import _jax_script
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 2
TOL = 1e-5
# (C, heads, N, the variants JAX's run_variant takes there)
CASES = [(78, 6, 20, VARIANTS), (24, 2, 20, VARIANTS), (254, 2, 20, VARIANTS),
         (96, 6, 40, VARIANTS), (39, 3, 20, (1, 3))]


def _inputs(C, n, seed=70):
    """x and (ln_w, ln_b, wqkv, bqkv, wproj, bproj) at width C, matrices
    (in, out), drawn as the script draws them (weights x0.05, x x0.5)."""
    rng = np.random.default_rng(seed + C + n)

    def r(*shape, s):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    params = (1 + r(C, s=0.1), r(C, s=0.1), r(C, 3 * C, s=0.05), r(3 * C, s=0.05),
              r(C, C, s=0.05), r(C, s=0.05))
    return r(B, n, C, s=0.5), params


def _torch_params(params):
    """The port's layout: matrices (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(p.T if p.ndim == 2 else p)) for p in params]


@pytest.mark.parametrize("C,H,n,variant",
                         [(C, H, n, v) for C, H, n, vs in CASES for v in vs])
def test_run_variant_matches_jax_at_every_width(C, H, n, variant):
    """Each variant's half-block output within rtol = atol = 1e-5 of JAX's
    `run_variant` (fp32, interpret mode) at d = 13, 12, 127, 16 (N = 40)
    and at an odd C."""
    x, params = _inputs(C, n)
    want = _jax_script().run_variant(variant, jnp.asarray(x), *[jnp.asarray(p) for p in params],
                                     num_heads=H, interpret=True)
    got = attn_variants.run_variant(variant, torch.from_numpy(x), *_torch_params(params),
                                    num_heads=H)
    assert got.shape == (B, n, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C,H", [(78, 6), (39, 3), (254, 2), (381, 3)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_the_padded_route_is_the_plain_version(C, H, variant):
    """At C % 8 != 0 the route pads x, the weights and every head to dp
    (16, 16, 128, 128), runs the kernel there and unpads: with the plain
    version at the padded widths in the kernel's place, out, qkv and attn
    equal the unpadded plain version's within fp32 rounding."""
    L = rowpad.block_layout(C, H)
    assert L is not None and L.Cp % rowpad.QUANTUM == 0 and L.dp <= 128
    x, params = _inputs(C, 17)
    x = torch.from_numpy(x)
    w = dict(zip(ATTN_BLOCK_KEYS, _torch_params(params)))
    scale = (C // H) ** -0.5

    def kernel(xp, wp):
        assert xp.shape[2] == L.Cp and wp["wqkv"].shape == (3 * L.Cp, L.Cp)
        return attention_variant_reference(variant, xp, *(wp[k] for k in ATTN_BLOCK_KEYS), H,
                                           scale=scale, stages=True, ln_width=C)

    got, st, padded = variant_route(x, w, H, kernel)
    want, want_st = attention_variant_reference(variant, x, *(w[k] for k in ATTN_BLOCK_KEYS),
                                                H, stages=True)
    assert padded and got.shape == x.shape
    for a, b in ((got, want), (st["qkv"], want_st["qkv"]), (st["attn"], want_st["attn"])):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_an_aligned_width_takes_no_padding():
    """C % 8 == 0 (heads of 12, 127 at eight heads) goes to the kernel as it
    is."""
    for C, H in ((384, 32), (1016, 8), (96, 6)):
        x = torch.zeros((1, 3, C))
        w = dict.fromkeys(ATTN_BLOCK_KEYS)
        seen = []
        out, st, padded = variant_route(x, w, H, lambda xp, wp: (seen.append(xp) or xp, {}))
        assert not padded and seen[0] is x and out is x


@pytest.mark.parametrize("d", [1, 12, 13, 64, 96, 127])
def test_the_rule_takes_every_width_to_the_ceiling(d):
    """True for every variant and head count at N = 1 and at the half-block's
    forward ceiling at d; false at N = 0 and one token past it."""
    limit = attention_max_tokens(d)
    assert limit > 0
    for v in VARIANTS:
        for heads in (1, 2, 3, 8):
            assert attention_variant_supported(v, 1, heads, d)
            assert attention_variant_supported(v, limit, heads, d)
            assert not attention_variant_supported(v, 0, heads, d)
            assert not attention_variant_supported(v, limit + 1, heads, d)


def test_the_rule_refuses_what_jax_refuses():
    """d = 128 (JAX's `av` has no ones column left), d = 0, no heads, and a
    variant outside 1-3; the wrapper's checks name each limit."""
    assert VARIANT_MAX_HEAD_DIM == 127 and attention_max_tokens(64) == 45824
    for v in VARIANTS:
        assert not attention_variant_supported(v, 197, 2, 128)
        assert not attention_variant_supported(v, 197, 2, 0)
        assert not attention_variant_supported(v, 197, 0, 64)
    assert not attention_variant_supported(4, 197, 6, 64)
    assert check_variant_shape(2, 197, 381, 3, "t") == 127
    assert check_variant_shape(1, 45824, 64, 1, "t") == 64
    with pytest.raises(ValueError, match="1 to 127"):
        check_variant_shape(1, 13, 256, 2, "t")
    with pytest.raises(ValueError, match="1 to 45824"):
        check_variant_shape(3, 45825, 64, 1, "t")
    with pytest.raises(ValueError, match="1 to 45824"):
        check_variant_shape(2, 0, 384, 6, "t")
    with pytest.raises(ValueError, match="head width"):
        check_variant_shape(1, 20, 100, 3, "t")
    with pytest.raises(ValueError, match="variant 0"):
        check_variant_shape(0, 20, 96, 6, "t")
