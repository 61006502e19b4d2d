"""Port parity of the DINO backbones: dense2sparse_vit_torch vs
dense2sparse_vit_tpu.

`models/dino.py` (DINOViT, DINOPredictorViT with its `_DinoPredictor`,
DINODistilledViT, DINOMaskedViT) against the JAX modules on the same
weights (`utils.convert.state_dict_from_jax`, and back with
`jax_params_from_state_dict`), headless and with a head, in eval and train
mode, with the Gumbel noise handed to both packages from numpy
(`test_torch_deit.same_draws`); the single-stage pruning model's gradients
in train mode (its keep decisions a policy through the blocks' policy
softmax) against `jax.grad`. fp32 on the CPU at depth 2, C = 128, 2 heads,
32-px images, patch 8 (16 patches); each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.models.dino as jax_dino
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig

import dense2sparse_vit_torch.models.dino as port_dino
from dense2sparse_vit_torch.core import ModelConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_deit import (
    MODEL,
    assert_outputs_close,
    assert_round_trip,
    build,
    images,
    jax_apply,
    port_apply,
    same_draws,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

HEADLESS = dict(MODEL, num_classes=0)
MASK_LOGITS = np.random.default_rng(9).standard_normal((16, 2)).astype(np.float32)
DINO_CASES = {  # name: (class, config, fields, call args, call keyword arguments)
    "vit_headless": ("DINOViT", HEADLESS, {}, (), {}),
    "vit_head": ("DINOViT", MODEL, {}, (), {}),
    "vit_selfattention": ("DINOViT", HEADLESS, {}, (), {"return_selfattention": True}),
    "distilled_headless": ("DINODistilledViT", HEADLESS, {}, (), {}),
    "distilled_head": ("DINODistilledViT", MODEL, {}, (), {}),
    "distilled_selfattention": ("DINODistilledViT", MODEL, {}, (),
                                {"return_selfattention": True}),
    "masked": ("DINOMaskedViT", MODEL, {}, (MASK_LOGITS,), {}),
    "masked_none": ("DINOMaskedViT", MODEL, {}, (), {}),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(DINO_CASES))
def test_dino_class_matches_jax(case, train):
    """Every output (CLS features or logits, per-layer logits, CLS rows,
    keep decisions) within 1e-5 of the JAX module's on the same weights and
    draws; the state_dict maps back to the JAX variables exactly."""
    name, cfg, fields, args, kw = DINO_CASES[case]
    jm, variables, pm = build(getattr(jax_dino, name), getattr(port_dino, name), cfg, **fields)
    x = images()
    with same_draws():
        want = jax_apply(jm, variables, x, train, *[jnp.asarray(a) for a in args], **kw)
        got = port_apply(pm, x, train, *[torch.from_numpy(a) for a in args], **kw)
    assert_outputs_close(got, want)
    assert_round_trip(pm, variables)


def _predictor_vit(cfg=HEADLESS, **fields):
    return build(jax_dino.DINOPredictorViT, port_dino.DINOPredictorViT, cfg,
                 **{"pruning_location": 1, **fields})


@pytest.mark.parametrize("cfg", [HEADLESS, MODEL], ids=["headless", "head"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_predictor_vit_matches_jax(cfg, train):
    """Eval: the top int(0.7 N) patches by the keep log-probability
    gathered at the stage; train: the Gumbel keep decisions as the blocks'
    policy from the stage on. The output and the decisions within 1e-5 of
    JAX's; the predictor's keys map back exactly."""
    jm, variables, pm = _predictor_vit(cfg)
    x = images()
    with same_draws():
        want = jm.apply(variables, jnp.asarray(x), training=train,
                        rngs={"gumbel": jax.random.PRNGKey(3)})
        got = port_apply(pm, x, train)
    assert (got[1] is None) == (not train)
    assert_outputs_close(got, want)
    assert_round_trip(pm, variables)


def test_dino_predictor_alone_matches_jax():
    """`_DinoPredictor` on (B, N, C) tokens: the (keep, drop)
    log-probabilities within 1e-6 of JAX's."""
    C = MODEL["embed_dim"]
    jp = jax_dino._DinoPredictor(C)
    x = np.random.default_rng(11).standard_normal((2, 16, C)).astype(np.float32)
    variables = jp.init(jax.random.PRNGKey(4), jnp.asarray(x))
    pp = port_dino._DinoPredictor(C)
    sd = state_dict_from_jax({"predictor": variables["params"]})
    pp.load_state_dict({k[len("predictor."):]: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jp.apply(variables, jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-6)


def test_predictor_vit_train_gradients_match_jax():
    """The train-mode output's dot with a fixed random (B, C) matrix
    differentiated in both packages on the same Gumbel draws: every
    parameter's gradient within 1e-4 of its largest magnitude (the
    straight-through decisions reach the predictor through the blocks'
    policy softmax)."""
    jm, variables, pm = _predictor_vit()
    x = images()
    r = np.random.default_rng(12).standard_normal((2, MODEL["embed_dim"])).astype(np.float32)

    def loss(params):
        out, _ = jm.apply({"params": params}, jnp.asarray(x), training=True,
                          rngs={"gumbel": jax.random.PRNGKey(3)})
        return jnp.sum(out * r)

    with same_draws():
        want = state_dict_from_jax(jax.grad(loss)(variables["params"]))
        pm.train()
        out, _ = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
        (out * torch.from_numpy(r)).sum().backward()
    grads = {k: p.grad for k, p in pm.named_parameters()}
    assert set(grads) == set(want)
    assert all(g is not None for g in grads.values())
    for k, g in grads.items():
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   rtol=0, err_msg=k)


def test_dino_patch8_registry_config():
    """dino_small at patch 8 (N = 785 at 224 px, the backward's long path
    on the card): the config and a small CPU forward at 32 px."""
    model = create_model("dino_small", patch_size=8, device="cpu", img_size=32, depth=1)
    assert model.cfg.patch_size == 8 and model.cfg.num_patches == 16
    assert model.pos_embed.shape == (1, 17, 384)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images(1)))
    assert out.shape == (1, 384) and torch.isfinite(out).all()
    full = JaxModelConfig(embed_dim=384, num_heads=6, patch_size=8)
    assert ModelConfig(embed_dim=384, num_heads=6, patch_size=8).num_patches == \
        full.num_patches == 784
