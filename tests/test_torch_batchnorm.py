"""TorchBatchNorm (nn/predictor.py) vs torch.nn.BatchNorm1d, unit level.

The flax.linen.BatchNorm it replaces updates the running variance with the
BIASED batch variance; torch uses the UNBIASED one. These tests pin the
exact torch semantics over multiple train-mode steps, for both the
predictor layout (B, N, D) and the aggregator layout (B, C, N) — the
trajectory test in test_gradient_parity.py covers only the predictor sites.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dense2sparse_vit_tpu.nn.predictor import TorchBatchNorm
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _run_pair(shape, steps=3, seed=0):
    """Run `steps` train-mode forwards through both BNs on fresh inputs.

    The feature axis is LAST for TorchBatchNorm and must be moved to dim 1
    for torch.nn.BatchNorm1d (the reference's BatchNormLayer transpose,
    dynamic_vit.py:350-367).
    """
    features = shape[-1]
    rng = np.random.default_rng(seed)

    tbn = torch.nn.BatchNorm1d(features)
    # non-trivial affine params so the normalized output is exercised too
    with torch.no_grad():
        tbn.weight.copy_(torch.tensor(
            rng.normal(1.0, 0.2, features).astype(np.float32)))
        tbn.bias.copy_(torch.tensor(
            rng.normal(0.0, 0.2, features).astype(np.float32)))
    tbn.train()

    fbn = TorchBatchNorm(features=features)
    x0 = jnp.zeros(shape, jnp.float32)
    variables = fbn.init(jax.random.PRNGKey(0), x0, use_running_average=False)
    params = {
        "scale": jnp.asarray(tbn.weight.detach().numpy()),
        "bias": jnp.asarray(tbn.bias.detach().numpy()),
    }
    stats = variables["batch_stats"]

    outs = []
    for _ in range(steps):
        x = rng.normal(size=shape).astype(np.float32)
        with torch.no_grad():
            tx = torch.tensor(x)
            if tx.ndim == 3:
                t_out = tbn(tx.transpose(1, 2)).transpose(1, 2).numpy()
            else:
                t_out = tbn(tx).numpy()
        f_out, mut = fbn.apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(x),
            use_running_average=False,
            mutable=["batch_stats"],
        )
        stats = mut["batch_stats"]
        outs.append((t_out, np.asarray(f_out)))

    return tbn, stats, outs


@pytest.mark.parametrize(
    "shape",
    [
        (4, 9, 16),  # predictor: (B, N, D), feature = channel dim
        (2, 16, 7),  # aggregator pyramid: (B, C, N), feature = token dim
        (8, 12),     # plain (B, C)
    ],
)
def test_matches_torch_batchnorm1d(shape):
    tbn, stats, outs = _run_pair(shape)
    for t_out, f_out in outs:
        np.testing.assert_allclose(f_out, t_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(stats["mean"]), tbn.running_mean.numpy(),
        rtol=1e-5, atol=1e-6,
    )
    # the unbiased-update semantics: at these small reduction counts the
    # Bessel correction is several percent, so the old biased update would
    # fail this tolerance outright
    np.testing.assert_allclose(
        np.asarray(stats["var"]), tbn.running_var.numpy(),
        rtol=1e-5, atol=1e-6,
    )


def test_biased_update_would_differ():
    """Guard the guard: with n small, biased vs unbiased running_var differ
    by ~n/(n-1); assert the pinned value is the UNBIASED one specifically."""
    shape = (2, 4, 6)  # n = 8 reduced elements per channel -> 14% correction
    tbn, stats, _ = _run_pair(shape)
    n = shape[0] * shape[1]
    ours = np.asarray(stats["var"])
    theirs = tbn.running_var.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    biased_equiv = 1.0 * 0.9**3 + (theirs - 1.0 * 0.9**3) * (n - 1) / n
    assert not np.allclose(ours, biased_equiv, rtol=1e-3)


def test_eval_mode_uses_running_stats():
    shape = (4, 9, 16)
    tbn, stats, _ = _run_pair(shape)
    tbn.eval()
    rng = np.random.default_rng(42)
    x = rng.normal(size=shape).astype(np.float32)
    with torch.no_grad():
        t_out = tbn(torch.tensor(x).transpose(1, 2)).transpose(1, 2).numpy()
    fbn = TorchBatchNorm(features=shape[-1])
    f_out = fbn.apply(
        {
            "params": {
                "scale": jnp.asarray(tbn.weight.detach().numpy()),
                "bias": jnp.asarray(tbn.bias.detach().numpy()),
            },
            "batch_stats": stats,
        },
        jnp.asarray(x),
        use_running_average=True,
    )
    np.testing.assert_allclose(np.asarray(f_out), t_out, rtol=1e-5, atol=1e-5)
