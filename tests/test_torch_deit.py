"""Port parity of the DeiT and ViT backbones: dense2sparse_vit_torch vs
dense2sparse_vit_tpu.

`models/deit.py` (DeiT, DistilledDeiT, VanillaDeiT, NonSpatialDeiT,
MaskedDistilledDeiT, MaskPredictorDeiT, `interpolate_pos_encoding`,
`forward_crops`) and `models/deit_heads.py` (HierarchicalDeiT, EnsembleDeiT
and their BatchNorm statistics) against the JAX modules on the same weights
(`utils.convert.state_dict_from_jax`, and back with
`jax_params_from_state_dict`), in eval and train mode; `resize_pos_embed`;
the registry's DeiT, ViT and DINO names and the aliases; the int8
dispatch of a plain DeiT and the row quantizer at ViT-L's MLP width; the
plain block backward at N = 400 (the kernel's long path on the card)
against `jax.vjp` of the JAX reference block; the CLI's config at 384 px.

The two packages draw different random numbers, so both get the same numpy
draws (`same_draws`): the port through `models.deit.patch_drop_scores` and
`ops.gumbel.uniform_noise`, the JAX modules through a `jax.random` stand-in
in their deit and gumbel modules (the patches live here; the JAX package is
unchanged). fp32 on the CPU at depth 2, C = 128, 2 heads, 32-px images,
patch 8 (16 patches); each test states its tolerance.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.cli as jax_cli
import dense2sparse_vit_tpu.models.deit as jax_deit
import dense2sparse_vit_tpu.models.deit_heads as jax_heads
import dense2sparse_vit_tpu.ops.gumbel as jax_gumbel
import dense2sparse_vit_tpu.ops.pallas.quant as jax_quant
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.models.registry import create_model as jax_create_model
from dense2sparse_vit_tpu.ops.pallas.block import _ref_block
from dense2sparse_vit_tpu.utils.convert import resize_pos_embed as jax_resize_pos_embed

import dense2sparse_vit_torch.models.deit as port_deit
import dense2sparse_vit_torch.models.deit_heads as port_heads
import dense2sparse_vit_torch.nn.layers as port_layers
import dense2sparse_vit_torch.ops.gumbel as port_gumbel
from dense2sparse_vit_torch import cli
from dense2sparse_vit_torch.core import ModelConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.models import registry as port_registry
from dense2sparse_vit_torch.ops.block import transformer_block_backward_reference
from dense2sparse_vit_torch.ops.quant import quantize_rows
from dense2sparse_vit_torch.utils.convert import (
    jax_params_from_state_dict,
    resize_pos_embed,
    state_dict_from_jax,
)
from test_torch_ops import _block_params
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

C, H = 128, 2
MODEL = dict(img_size=32, patch_size=8, embed_dim=C, depth=2, num_heads=H, num_classes=10)
TOL = 1e-5  # fp32, the same operations in another order


@contextlib.contextmanager
def same_draws(seed=0):
    """Within the context, both packages' uniform draws (the patch drop's
    scores, the Gumbel noise) come from numpy streams seeded alike: the
    i-th draw of a shape is the same array on both sides."""
    jr, pr = np.random.default_rng(seed), np.random.default_rng(seed)

    def jax_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(jr.random(tuple(shape)).astype(np.float32))

    def port_uniform(shape, generator):
        return torch.from_numpy(pr.random(tuple(shape)).astype(np.float32))

    fake = types.SimpleNamespace(random=types.SimpleNamespace(uniform=jax_uniform),
                                 lax=jax.lax, nn=jax.nn, image=jax.image, jit=jax.jit,
                                 tree_util=jax.tree_util)
    saved = (jax_deit.jax, jax_gumbel.jax, port_deit.patch_drop_scores,
             port_gumbel.uniform_noise)
    jax_deit.jax = jax_gumbel.jax = fake
    port_deit.patch_drop_scores = port_gumbel.uniform_noise = port_uniform
    try:
        yield
    finally:
        (jax_deit.jax, jax_gumbel.jax, port_deit.patch_drop_scores,
         port_gumbel.uniform_noise) = saved


def images(n=2, side=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, side, side, 3)).astype(np.float32)


RNGS = ("params", "gumbel", "patch_drop")


def build(jax_cls, port_cls, cfg=None, seed=1, **fields):
    """The JAX module initialised on a seed and the port's module with its
    weights (and BatchNorm statistics), strictly loaded."""
    cfg = dict(MODEL if cfg is None else cfg)
    jm = jax_cls(cfg=JaxModelConfig(**cfg), **fields)
    keys = dict(zip(RNGS, jax.random.split(jax.random.PRNGKey(seed), len(RNGS))))
    variables = jm.init(keys, jnp.asarray(images(1, cfg["img_size"])))
    pm = port_cls(ModelConfig(**cfg), **fields)
    sd = state_dict_from_jax(variables)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jm, variables, pm


def leaves(out):
    """The arrays of a (nested tuple of) output(s), None left out, as numpy."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in leaves(o)]
    return [out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)]


def assert_outputs_close(got, want, tol=TOL):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def jax_apply(jm, variables, x, train, *args, **kw):
    """JAX forward in eval (deterministic) or train mode, with every rng
    stream the module may ask for."""
    keys = dict(zip(RNGS[1:], jax.random.split(jax.random.PRNGKey(7), 2)))
    return jm.apply(variables, jnp.asarray(x), *args, deterministic=not train, rngs=keys, **kw)


def port_apply(pm, x, train, *args, **kw):
    pm.train(train)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        return pm(torch.from_numpy(x), *args, generator=gen, **kw)


def assert_round_trip(pm, variables):
    """The port's state_dict mapped back to JAX equals the JAX variables."""
    back = jax_params_from_state_dict(pm.state_dict())
    want = {k: v for k, v in dict(variables).items() if v}
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- position embeddings -------------------------------------------------------


@pytest.mark.parametrize("old,new,n_extra", [(4, 6, 1), (6, 4, 1), (14, 24, 2), (24, 14, 1)])
def test_interpolate_pos_encoding_matches_jax(old, new, n_extra):
    """Growing (plain bilinear) and shrinking (antialiased, as
    jax.image.resize by default) a grid, within 1e-6."""
    pe = np.random.default_rng(old * new).standard_normal(
        (1, n_extra + old * old, 8)).astype(np.float32)
    want = jax_deit.interpolate_pos_encoding(jnp.asarray(pe), new * new, n_extra)
    got = port_deit.interpolate_pos_encoding(torch.from_numpy(pe), new * new, n_extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    same = torch.from_numpy(pe)
    assert port_deit.interpolate_pos_encoding(same, old * old, n_extra) is same


@pytest.mark.parametrize("n_extra", [1, 2])
def test_resize_pos_embed_matches_jax(n_extra):
    """A 224-px checkpoint's grid into a 384-px model (14 -> 24), within
    1e-6; the same grid passes through."""
    pe = np.random.default_rng(n_extra).standard_normal((1, n_extra + 196, 16)).astype(np.float32)
    want = jax_resize_pos_embed(pe, n_extra + 576, n_extra)
    got = resize_pos_embed(pe, n_extra + 576, n_extra)
    assert got.shape == (1, n_extra + 576, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert resize_pos_embed(pe, n_extra + 196, n_extra) is pe


# ---- the DeiT classes ------------------------------------------------------------

MASK_LOGITS = np.random.default_rng(3).standard_normal((16, 2)).astype(np.float32)
DEIT_CASES = {  # name: (class, fields, call args, call keyword arguments)
    "deit": ("DeiT", {}, (), {}),
    "deit_selfattention": ("DeiT", {}, (), {"return_selfattention": True}),
    "distilled": ("DistilledDeiT", {}, (), {}),
    "distilled_per_layer": ("DistilledDeiT", {}, (), {"return_per_layer": True}),
    "vanilla": ("VanillaDeiT", {}, (), {}),
    "vanilla_patch_drop": ("VanillaDeiT", {}, (), {"block_index": 1, "drop_rate": 0.5}),
    "nonspatial": ("NonSpatialDeiT", {}, (), {}),
    "masked": ("MaskedDistilledDeiT", {"mask_block": 1}, (MASK_LOGITS,), {}),
    "masked_soft": ("MaskedDistilledDeiT", {"mask_block": 0}, (MASK_LOGITS,),
                    {"hard": False, "tau": 0.5}),
    "masked_none": ("MaskedDistilledDeiT", {}, (), {}),
    "predictor": ("MaskPredictorDeiT", {}, (), {}),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(DEIT_CASES))
def test_deit_class_matches_jax(case, train):
    """Every output of the forward (logits, per-layer tokens, CLS rows,
    keep decisions) within 1e-5 of the JAX module's on the same weights and
    draws; the state_dict maps back to the JAX variables exactly."""
    name, fields, args, kw = DEIT_CASES[case]
    jm, variables, pm = build(getattr(jax_deit, name), getattr(port_deit, name), **fields)
    x = images()
    with same_draws():
        want = jax_apply(jm, variables, x, train, *[jnp.asarray(a) for a in args], **kw)
        got = port_apply(pm, x, train, *[torch.from_numpy(a) for a in args], **kw)
    assert_outputs_close(got, want)
    assert_round_trip(pm, variables)


def test_vanilla_patch_drop_keeps_the_scores_top_patches():
    """The drop keeps n - int(n rate) patches and the CLS token: the
    per-layer logits after the drop differ from the undropped ones."""
    _, _, pm = build(jax_deit.VanillaDeiT, port_deit.VanillaDeiT)
    x = images()
    with same_draws():
        dropped = port_apply(pm, x, False, block_index=0, drop_rate=0.5)
    full = port_apply(pm, x, False)
    assert len(dropped) == 2 and not torch.allclose(dropped[-1], full[-1])
    with pytest.raises(ValueError, match="Generator"):
        pm(torch.from_numpy(x), drop_rate=0.5)


def test_deit_at_another_resolution_interpolates_like_jax():
    """A 48-px input (36 patches) through a model built for 32 px: the
    position embedding resized on the fly, within 1e-5 of JAX."""
    jm, variables, pm = build(jax_deit.DeiT, port_deit.DeiT)
    x = images(2, 48)
    assert_outputs_close(port_apply(pm, x, False), jax_apply(jm, variables, x, False))


def test_forward_crops_matches_jax_and_keeps_the_input_order():
    """Crops of 32, 48 and 32 px: two forwards, the outputs in the crops'
    order, each within 1e-5 of the JAX multi-crop forward and of the crop's
    own forward."""
    jm, variables, pm = build(jax_deit.DistilledDeiT, port_deit.DistilledDeiT)
    crops = [images(2, 32, 1), images(1, 48, 2), images(3, 32, 3)]
    calls = []
    forward = pm.forward

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return forward(*a, **kw)

    pm.eval()
    pm.forward = counted
    with torch.no_grad():
        got = port_deit.forward_crops(pm, [torch.from_numpy(c) for c in crops])
    want = jax_deit.forward_crops(jm, variables, [jnp.asarray(c) for c in crops])
    assert [tuple(s) for s in calls] == [(5, 32, 32, 3), (1, 48, 48, 3)]
    for g, w, c in zip(got, want, crops):
        assert g[0].shape[0] == c.shape[0]
        assert_outputs_close(g, w)
        with torch.no_grad():
            assert_outputs_close(g, pm(torch.from_numpy(c)))


# ---- the hierarchical and ensemble heads ------------------------------------------


@pytest.mark.parametrize("name,kw", [("HierarchicalDeiT", {}), ("EnsembleDeiT", {}),
                                     ("EnsembleDeiT", {"get_average": True})])
def test_heads_match_jax_with_their_batch_statistics(name, kw):
    """One train-mode forward: the outputs within 1e-5 of JAX's and the
    heads' running statistics (each BatchNorm applied twice, so moved twice,
    flax's biased variance) within 1e-6 of JAX's updated batch_stats; then
    an eval forward on those statistics within 1e-5."""
    jm, variables, pm = build(getattr(jax_heads, name), getattr(port_heads, name))
    assert "batch_stats" in variables
    assert_round_trip(pm, variables)
    x = images()
    want, updated = jm.apply(variables, jnp.asarray(x), deterministic=False,
                             mutable=["batch_stats"], **kw)
    got = port_apply(pm, x, True, **kw)
    assert_outputs_close(got, want)
    stats = state_dict_from_jax({"params": variables["params"], **updated})
    state = pm.state_dict()
    moved = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(moved) == 2 * (MODEL["depth"] - 1)
    for k in moved:
        np.testing.assert_allclose(state[k].numpy(), stats[k], atol=1e-6, rtol=1e-6)
        assert not np.allclose(stats[k], state_dict_from_jax(variables)[k])
    after = {"params": variables["params"], **updated}
    assert_outputs_close(port_apply(pm, x, False, **kw),
                         jm.apply(after, jnp.asarray(x), deterministic=True, **kw))


def test_ensemble_quadrants_are_quarters_of_the_sequence():
    """The four spatial heads read patches 0-3, 4-7, 8-11 and 12-15 of the
    sequence: changing the last four patches' tokens moves only the last
    quadrant's logits."""
    _, _, pm = build(jax_heads.EnsembleDeiT, port_heads.EnsembleDeiT)
    pm.eval()
    toks = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 17, C)).astype(np.float32))
    quads = []
    for t in (toks, torch.cat([toks[:, :13], toks[:, 13:] + 1.0], dim=1)):
        with torch.no_grad():
            x = pm.norm(t)[:, 1:]
            quads.append([pm.spatialheads[i](x[:, 4 * i:4 * i + 4].mean(1)) for i in range(4)])
    assert all(torch.equal(a, b) for a, b in zip(quads[0][:3], quads[1][:3]))
    assert not torch.equal(quads[0][3], quads[1][3])


# ---- the registry ------------------------------------------------------------------

SMALL = dict(img_size=32, patch_size=8, embed_dim=C, depth=2, num_heads=H)
NEW_NAMES = [
    "deit_tiny_patch16_224", "deit_small_patch16_224", "deit_base_patch16_224",
    "deit_base_patch16_384", "deit_tiny_distilled_patch16_224",
    "deit_small_distilled_patch16_224", "deit_base_distilled_patch16_224",
    "vanilla_deit_tiny_patch16_224", "vanilla_deit_small_patch16_224",
    "vanilla_deit_base_patch16_224", "nonspatial_deit_small_patch16_224",
    "deit_small_patch16_224_masked", "deit_small_patch16_224_predictor",
    "tiny_patch16_224_hierarchical", "small_patch16_224_hierarchical",
    "base_patch16_224_hierarchical", "tiny_patch16_224_ensemble", "small_patch16_224_ensemble",
    "vit_base_patch16_224", "vit_base_patch16_384", "vit_base_patch32_384",
    "vit_large_patch16_224", "vit_large_patch16_384", "vit_large_patch32_384",
    "dino_tiny", "dino_small", "dino_base", "dino_small_predictor", "dino_small_dist",
    "dino_tiny_dist", "dino_small_patch16_224_masked",
]
ALIASES = ["T2t_vit_7", "T2t_vit_10", "T2t_vit_12", "T2t_vit_14", "T2t_vit_19", "T2t_vit_24",
           "T2t_vit_t_14", "T2t_vit_t_19", "T2t_vit_t_24", "vit_deit_tiny_patch16_224",
           "vit_deit_small_patch16_224", "vit_deit_base_patch16_224",
           "vit_deit_small_distilled_patch16_224", "deit_small_dist_masked",
           "deit_small_dist_predictor"]
_CFG_KEYS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio",
             "num_classes", "qkv_bias", "layer_norm_eps")


def test_registry_holds_the_new_names_and_aliases():
    """The backbones' 31 names and 15 aliases are registered. Since the
    kernels take every even head width, the registry holds the JAX one's 65
    names and 18 aliases (`tests/test_torch_zoo.py`), vit_small_patch16_224
    (8 heads of 96) among them."""
    assert len(NEW_NAMES) == 31 and len(ALIASES) == 15
    assert set(NEW_NAMES) <= set(port_registry.list_models())
    assert len(port_registry.list_models()) == 65
    assert set(ALIASES) <= set(port_registry._ALIASES) and len(port_registry._ALIASES) == 18
    assert "vit_small_patch16_224" in port_registry.list_models()


@pytest.mark.parametrize("name", NEW_NAMES)
def test_new_name_builds_on_the_cpu_as_jax_builds_it(name):
    """The class and the config the JAX factory gives (at full size, built
    on the meta device), and a small build on the CPU whose forward runs."""
    want = jax_create_model(name)
    with torch.device("meta"):
        port = port_registry._REGISTRY[name]()
    assert type(port).__name__ == type(want).__name__
    for k in _CFG_KEYS:
        assert getattr(port.cfg, k) == getattr(want.cfg, k), k
    for k in type(port).FIELDS:
        assert getattr(port, k) == getattr(want, k), k
    small = create_model(name, device="cpu", **SMALL)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = small.eval()(torch.from_numpy(images(1)), generator=gen)
    assert all(np.isfinite(a).all() for a in leaves(out))


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_builds_its_target_on_the_cpu(alias):
    target = port_registry._ALIASES[alias]
    kw = SMALL if not alias.startswith("T2t") else dict(img_size=32)
    model = create_model(alias, device="cpu", **kw)
    with torch.device("meta"):
        assert type(model) is type(port_registry._REGISTRY[target](**kw))
    assert type(model).__name__ == type(jax_create_model(alias)).__name__


# ---- int8, the long-sequence backward, the 384-px CLI -----------------------------


def test_plain_deit_dispatches_its_blocks_to_int8(monkeypatch):
    """As the JAX Block threads quant to every DeiT-family block
    (`tests/test_quant_block.py::test_vanilla_deit_threads_quant`): a plain
    DeiT built with quant="int8" runs each block's eval forward through
    `fused_transformer_block_int8` (its plain version on the CPU), and its
    logits stay within cos 0.99 of the unquantized model's."""
    calls = []
    orig = port_layers.fused_transformer_block_int8

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(port_layers, "fused_transformer_block_int8", spy)
    kw = dict(SMALL, num_classes=5, use_fused_attention=True)
    model = create_model("deit_small_patch16_224", device="cpu", quant="int8", **kw).eval()
    plain = create_model("deit_small_patch16_224", device="cpu", **kw).eval()
    x = torch.from_numpy(images())
    with torch.no_grad():
        a, b = model(x), plain(x)
    assert len(calls) == 2
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    assert torch.isfinite(a).all() and cos > 0.99


def test_row_quantizer_at_vit_large_mlp_width():
    """Rows of 4096 (ViT-L's hidden width, the kernel's new widest
    instantiation): codes equal to JAX's, scales within 1e-7."""
    h = np.random.default_rng(4096).standard_normal((6, 4096)).astype(np.float32)
    want_q, want_s = jax_quant._quantize_rows(jnp.asarray(h))
    got_q, got_s = quantize_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)


_KEYS = {"ln1_scale": "ln1_w", "ln1_bias": "ln1_b", "wqkv": "wqkv", "bqkv": "bqkv",
         "wproj": "wproj", "bproj": "bproj", "ln2_scale": "ln2_w", "ln2_bias": "ln2_b",
         "w1": "w1", "b1": "b1", "w2": "w2", "b2": "b2"}


@pytest.mark.parametrize("policy", [False, True], ids=["plain", "policy"])
def test_plain_block_backward_at_400_tokens_matches_jax_vjp(policy):
    """N = 400 (past the one-CTA backward's 384; the card's long path
    holds the same function), B = 1, C = 128: dx, the twelve gradients and
    in policy mode dPolicy of the port's plain block backward within 2e-4
    (relative to each tensor's largest value) of `jax.vjp` of the JAX
    reference block `_ref_block`."""
    n = 400
    p = _block_params(C, 4 * C, seed=400)
    rng = np.random.default_rng(401)
    x = rng.standard_normal((1, n, C)).astype(np.float32)
    g = rng.standard_normal((1, n, C)).astype(np.float32)
    pol = (rng.random((1, n)) < 0.6).astype(np.float32) if policy else None
    if policy:
        pol[:, 0] = 1.0
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(x, params, pol):
        return _ref_block(x, params, H, pol, None, 1e-6)

    _, vjp = jax.vjp(f, jnp.asarray(x), jp, None if pol is None else jnp.asarray(pol))
    want_dx, want_dw, want_dpol = vjp(jnp.asarray(g))
    w = {_KEYS[k]: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
         for k, v in p.items()}
    dx, dw, dpol = transformer_block_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), w, H, (C // H) ** -0.5, 1e-6,
        policy=None if pol is None else torch.from_numpy(pol))

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=0)

    close(dx.numpy(), want_dx)
    for k, v in want_dw.items():
        got = dw[_KEYS[k]].numpy()
        close(got.T if got.ndim == 2 else got, v)
    if policy:
        close(dpol.numpy(), want_dpol)


def test_cli_config_at_384_px_matches_jax():
    """`--arch deit_base --img-size 384 --eval-crop 384` with the headline's
    stages and keep ratios: every config field as the JAX CLI gives it, 576
    patches kept to 403 / 282 / 197."""
    argv = ["--arch", "deit_base", "--img-size", "384", "--eval-crop", "384",
            "--pruning-locs", "3", "6", "9", "--keep-ratios", "0.7", "0.49", "0.343",
            "--small-predictor"]
    got, _ = cli.parse_config(argv + ["--device", "cpu"])
    want, _ = jax_cli.parse_config(argv)
    for part in ("model", "pruning", "train", "data"):
        g, w = getattr(got, part), getattr(want, part)
        for k in g.__dataclass_fields__:
            assert getattr(g, k) == getattr(w, k), (part, k)
    assert got.model.num_patches == 576 and got.model.embed_dim == 768
    assert got.pruning.keep_counts(576) == (403, 282, 197)
