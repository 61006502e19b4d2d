"""Port parity of the attention half-block's inference schedules v0-v3
(`dense2sparse_vit_torch/scripts/attn_variants.py` vs the JAX package's
`scripts/attn_variants.py`, loaded by path), and the ported script's CPU
smoke.

At the script's own CPU shapes (B=4, N=20, C=96, 6 heads), fp32: the same
numpy inputs (weights x0.05, x x0.5, as the script draws them) go through
JAX's `run_variant` (its Pallas kernel in interpret mode; v0 is
`fused_attention_block`) and the port's, which runs the plain versions for
CPU tensors. The TPU variants' exp(clip(s, -30, 30)) without a row max
agrees with the port's exact softmax here: every scaled logit is far
inside +-30.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention

from dense2sparse_vit_torch.scripts import attn_variants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, C, H = 4, 20, 96, 6


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_attn_variants", os.path.join(REPO, "scripts", "attn_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed=60):
    """x and (ln_w, ln_b, wqkv, bqkv, wproj, bproj), matrices (in, out)."""
    rng = np.random.default_rng(seed)

    def r(*shape, s):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    params = (1 + r(C, s=0.1), r(C, s=0.1), r(C, 3 * C, s=0.05), r(3 * C, s=0.05),
              r(C, C, s=0.05), r(C, s=0.05))
    return r(B, N, C, s=0.5), params


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_run_variant_matches_jax(variant):
    """Each variant's half-block output within rtol = atol = 1e-5 of JAX's
    (fp32; the TPU kernel folds LN1 into the qkv weights and pads N to
    32)."""
    x, params = _inputs()
    jp = [jnp.asarray(p) for p in params]
    if variant == 0:
        want = jax_attention.fused_attention_block(jnp.asarray(x), *jp, num_heads=H,
                                                   interpret=True)
    else:
        want = _jax_script().run_variant(variant, jnp.asarray(x), *jp, num_heads=H,
                                         interpret=True)
    tp = [torch.from_numpy(np.ascontiguousarray(p.T if p.ndim == 2 else p)) for p in params]
    got = attn_variants.run_variant(variant, torch.from_numpy(x), *tp, num_heads=H)
    assert got.shape == (B, N, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paired_attention_reference_is_the_exact_attention():
    """v2's sum/difference algebra recovers each head's scores: its core
    equals the plain attention within fp32 rounding, with an odd last head
    (5 heads) run alone."""
    from dense2sparse_vit_torch.ops.attention import paired_attention_reference
    from dense2sparse_vit_torch.ops.block import attention_reference

    qkv = torch.from_numpy(np.random.default_rng(61).standard_normal((2, 13, 3 * 80))
                           .astype(np.float32))
    for heads in (4, 5):
        got = paired_attention_reference(qkv, heads, 0.25)
        want = attention_reference(qkv, heads, 0.25)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_main_on_the_cpu_prints_every_variant(capsys):
    """--device cpu: one line per variant with max|diff vs v0|, and rows
    whose output and core stay within fp32 rounding of v0's."""
    rows = attn_variants.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["variant"] for r in rows] == [0, 1, 2, 3]
    for v in range(4):
        assert f"v{v}: max|diff vs v0|" in out
    for r in rows:
        assert r["N"] == 20 and r["B"] == 4 and "ms" not in r
        assert r["core_rel_vs_v0"] < 2e-2 and r["out_rel_vs_v0"] < 2e-2
