"""Port parity of the rest of the model zoo: the T2T-ViT SE, Ghost and Dense
variants, TNT and the Drop-ResNet (dense2sparse_vit_torch vs
dense2sparse_vit_tpu), and the two registries.

Each family at a small size (depth 2, narrow widths, 32-px images; the
ResNet with one bottleneck a stage), fp32 on the CPU: the JAX module
initialised on a seed, its variables carried onto the port's module by
`state_dict_from_jax` (strict load), both run on the same numpy images, and
the port's state_dict mapped back by `jax_params_from_state_dict`, bit for
bit. The ResNet's spatial drop takes the same uniforms on both sides (the
JAX module's `jax.random.uniform` and the port's `spatial_drop_draws` fed
from one numpy seed). TOL: fp32, the same operations in another order
(the T2T performer stem's exponential features among them), relative to
logits of order one.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.models.resnet as jax_resnet
import dense2sparse_vit_tpu.models.t2t as jax_t2t
import dense2sparse_vit_tpu.models.tnt as jax_tnt
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.models import registry as jax_registry

import dense2sparse_vit_torch.models.resnet as port_resnet
import dense2sparse_vit_torch.models.t2t as port_t2t
import dense2sparse_vit_torch.models.tnt as port_tnt
from dense2sparse_vit_torch.core import ModelConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.models import registry as port_registry
from dense2sparse_vit_torch.utils.convert import jax_params_from_state_dict, state_dict_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4
T2T = dict(img_size=32, embed_dim=64, depth=2, num_heads=2, mlp_ratio=2.0, qkv_bias=False,
           layer_norm_eps=1e-5, num_classes=10)
TNT_CFG = dict(img_size=32, patch_size=8, embed_dim=48, depth=2, num_heads=2, qkv_bias=False,
               layer_norm_eps=1e-5, num_classes=10)
# name: (JAX class, port class, config (None: the ResNet's fields), fields)
FAMILIES = {
    "se": (jax_t2t.T2TViTSE, port_t2t.T2TViTSE, T2T, {}),
    "ghost": (jax_t2t.T2TViTGhost, port_t2t.T2TViTGhost, T2T, {}),
    "dense": (jax_t2t.T2TViTDense, port_t2t.T2TViTDense, dict(T2T, embed_dim=32),
              {"growth_rate": 16, "block_config": (2, 1)}),
    "tnt": (jax_tnt.TNT, port_tnt.TNT, TNT_CFG, {"in_dim": 12, "in_num_head": 2}),
    "resnet": (jax_resnet.DropResNet, port_resnet.DropResNet, None,
               {"stage_sizes": (1, 1, 1, 1), "num_classes": 10}),
}


def images(n=2, side=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, side, side, 3)).astype(np.float32)


def build(name, seed=1):
    """The JAX module initialised on a seed, its variables, and the port's
    module with them loaded strictly."""
    jax_cls, port_cls, cfg, fields = FAMILIES[name]
    if cfg is None:
        jm, pm = jax_cls(**fields), port_cls(**fields)
    else:
        jm = jax_cls(cfg=JaxModelConfig(**cfg), **fields)
        pm = port_cls(ModelConfig(**cfg), **fields)
    variables = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(seed)},
                                        jnp.asarray(images(1))))()
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    sd = state_dict_from_jax(variables)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jm, variables, pm.eval()


def assert_round_trip(pm, variables):
    """The port's state_dict mapped back to JAX equals the JAX variables."""
    back = jax_params_from_state_dict(pm.state_dict())
    want = {k: v for k, v in variables.items() if v}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["se", "ghost", "dense", "tnt"])
def test_family_eval_forward_matches_jax(name):
    """The eval forward's logits within TOL of JAX's on JAX's weights, and
    the converter's round trip bit-exact."""
    jm, variables, pm = build(name)
    x = images()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(variables, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert_round_trip(pm, variables)


def test_dense_variant_grows_and_halves_the_width():
    """(2, 1) layers of growth 16 from 32: 32 -> 48 -> 64, halved to 32, ->
    48; the inner blocks stay plain under use_fused_attention."""
    _, _, pm = build("dense")
    assert [b.dense.weight.shape[1] for b in pm.blocks] == [32, 48, 32]
    assert [t.dense.weight.shape for t in pm.transition] == [(32, 64)]
    assert pm.norm.weight.shape == (48,)
    m = create_model("t2t_vit_dense", use_fused_attention=True, device="cpu", img_size=32,
                     block_config=(1, 1))
    assert m.cfg.use_fused_attention and not any(b.inner.use_fused for b in m.blocks)


def _same_uniforms(seed=0):
    """The ResNet's spatial-drop uniforms from one numpy stream on both
    sides: (the JAX module's stand-in for `jax`, the port's draws)."""
    jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)

    def jax_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(jr.random(tuple(shape)).astype(np.float32))

    def port_uniform(shape, generator):
        return torch.from_numpy(pr.random(tuple(shape)).astype(np.float32))

    return types.SimpleNamespace(random=types.SimpleNamespace(uniform=jax_uniform)), port_uniform


@pytest.mark.parametrize("drop_layer", [2, 5])
def test_resnet_train_step_and_eval_match_jax(monkeypatch, drop_layer):
    """Train mode (batch statistics, the running statistics moved as flax
    moves them) with the spatial drop at `drop_layer` (0: none) on the same
    uniforms, then eval mode on the moved statistics: logits within TOL,
    every running statistic within TOL, the round trip bit-exact."""
    jm, variables, pm = build("resnet")
    fake_jax, port_uniform = _same_uniforms()
    monkeypatch.setattr(jax_resnet, "jax", fake_jax)
    monkeypatch.setattr(port_resnet, "spatial_drop_draws", port_uniform)
    x = images(4)
    kw = dict(drop_percent=0.3, drop_layer=drop_layer)
    want, updates = jax.jit(lambda v, x: jm.apply(
        v, x, use_running_average=False, mutable=["batch_stats"],
        rngs={"feature_drop": jax.random.PRNGKey(3)}, **kw))(variables, x)
    pm.train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    moved = dict(variables, batch_stats=jax.tree_util.tree_map(np.asarray,
                                                               updates["batch_stats"]))
    back = jax_params_from_state_dict(pm.state_dict())["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(moved["batch_stats"])):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    pm.eval()
    want = jax.jit(jm.apply)(moved, x)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_resnet_round_trip_and_key_layout():
    """torchvision's key layout (conv1, bn1, layer{s}.{b}.downsample.{0,1},
    fc), the running statistics from 'batch_stats', bit-exact back."""
    _, variables, pm = build("resnet")
    sd = pm.state_dict()
    assert "layer2.0.downsample.0.weight" in sd and "layer1.0.bn3.running_var" in sd
    assert int(sd["bn1.num_batches_tracked"]) == 0
    assert_round_trip(pm, variables)


def test_drop_resnet_spatial_mask_is_shared_over_batch_and_channels(monkeypatch):
    """A drop of 1.0 before stage 1 zeroes every position: the logits are
    the classifier's bias; a drop of 0 leaves the forward as it is."""
    _, _, pm = build("resnet")
    x = torch.from_numpy(images(2))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = pm(x, drop_percent=1.0, drop_layer=1, generator=gen)
        same = pm(x, drop_percent=0.0, drop_layer=1)
        plain = pm(x)
    torch.testing.assert_close(out, pm.fc.bias.expand(2, -1), rtol=0, atol=1e-6)
    assert torch.equal(same, plain)
    with pytest.raises(ValueError, match="Generator"):
        pm(x, drop_percent=0.5, drop_layer=2)


def test_registry_matches_jax():
    """The port's create_model takes every name (65) and alias (18) of the
    JAX registry, each alias to the same target."""
    assert port_registry.list_models() == jax_registry.list_models()
    assert len(port_registry.list_models()) == 65
    assert port_registry._ALIASES == jax_registry._ALIASES
    assert len(port_registry._ALIASES) == 18


# the new names, at their widths and depths on 32-px images (the ResNet has
# no img_size: its convolutions take any side)
NEW_NAMES = ("vit_small_patch16_224", "t2t_vit_14_resnext", "t2t_vit_14_wide", "t2t_vit_14_se",
             "t2t_vit_16_ghost", "t2t_vit_dense", "tnt_s_patch16_224", "tnt_b_patch16_224",
             "drop_resnet50")


@pytest.mark.parametrize("name", NEW_NAMES)
def test_new_names_build_at_their_widths(name):
    """Each new name builds at its full width and depth on the CPU and runs
    a forward; the JAX registry's module has the same parameters, by name
    and shape."""
    kw = {} if name == "drop_resnet50" else {"img_size": 32}
    m = create_model(name, device="cpu", **kw).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(images(1)))
    out = out[-1] if isinstance(out, tuple) else out  # the ViT's per-layer logits
    assert out.shape == (1, 1000) and torch.isfinite(out).all()
    jm = jax_registry.create_model(name, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    want = state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                      dict(shapes)))
    assert {k: tuple(v.shape) for k, v in want.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}


@pytest.mark.parametrize("alias", ["T2t_vit_14_resnext", "T2t_vit_14_wide", "T2t_vit_16_ghost"])
def test_aliases_build_their_targets(alias):
    m = create_model(alias, device="cpu", img_size=32)
    target = create_model(port_registry._ALIASES[alias], device="cpu", img_size=32)
    assert type(m) is type(target) and m.cfg == target.cfg
