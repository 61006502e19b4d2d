"""Port parity of the whole slice: the pruned student, and its weight mapping.

A tiny student (32 px images, patch 8, depth 4, C=64, 2 heads, pruning at
blocks 1/2/3 with the headline keep ratios 0.7/0.49/0.343, small or large
predictor, fp32) runs in the JAX package, with its Pallas kernels in
interpret mode and without them, and in the port on the same weights and
images.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.block as jax_block
import dense2sparse_vit_tpu.ops.pallas.gather as jax_gather
import dense2sparse_vit_tpu.ops.pallas.predictor as jax_predictor
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.utils.convert import export_student_state_dict

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state, random_like_tree

MODEL = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2,
             num_classes=10)
PRUNING = dict(pruning_locs=(1, 2, 3), keep_ratios=(0.7, 0.49, 0.343))
B = 2


def _images(seed=10):
    return np.random.default_rng(seed).standard_normal(
        (B, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(small):
    student = JaxStudent(
        cfg=JaxModelConfig(**MODEL),
        pruning=JaxPruningConfig(small_predictor=small, **PRUNING),
    )
    shapes = jax.eval_shape(
        student.init, jax.random.PRNGKey(0), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=11 + small)


def _port(small, use_fused):
    model = create_model(
        "dynamic_vit_small_patch16_224_student", small_predictor=small,
        use_fused_attention=use_fused, device="cpu", **MODEL, **PRUNING,
    )
    return load_numpy_state(model, state_dict_from_jax(_jax_params(small))).eval()


@functools.lru_cache(maxsize=None)
def _jax_forward(small, use_fused):
    student = JaxStudent(
        cfg=JaxModelConfig(use_fused_attention=use_fused, **MODEL),
        pruning=JaxPruningConfig(small_predictor=small, **PRUNING),
    )
    run = jax.jit(lambda p, x: student.apply(
        {"params": p}, x, collect_cls_attns=False))
    if not use_fused:
        return run(_jax_params(small), jnp.asarray(_images()))
    # the CPU runs the Pallas kernels in interpret mode
    gather = jax_gather.fused_gather_tokens
    patches = [
        (jax_block, "fused_transformer_block", functools.partial(
            jax_block.fused_transformer_block, interpret=True)),
        (jax_predictor, "fused_predictor_lg", functools.partial(
            jax_predictor.fused_predictor_lg, interpret=True)),
        (jax_gather, "fused_gather_tokens",
         lambda x, idx: gather(x, idx, 8, True)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        return run(_jax_params(small), jnp.asarray(_images()))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@pytest.mark.parametrize("small", [True, False])
def test_state_dict_from_jax_matches_export_bit_exactly(small):
    params = _jax_params(small)
    port_sd = {k: v.numpy() for k, v in _port(small, False).state_dict().items()}
    exported, passthrough = export_student_state_dict(params, port_sd)
    got = state_dict_from_jax(params)
    assert not passthrough
    assert set(got) == set(port_sd) == set(exported)
    for k in port_sd:
        np.testing.assert_array_equal(got[k], exported[k], err_msg=k)
        assert got[k].dtype == port_sd[k].dtype and got[k].shape == port_sd[k].shape


@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("jax_fused", [True, False])
@pytest.mark.parametrize("port_fused", [True, False])
def test_student_matches_jax(small, jax_fused, port_fused):
    want = _jax_forward(small, jax_fused)
    model = _port(small, port_fused)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = model(torch.from_numpy(_images()), collect_cls_attns=False)
    # CPU tensors never reach a kernel
    assert all(n == 0 for n in ops.launch_counts().values())
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **tol)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **tol)
    assert len(got.pred_logits) == len(want.pred_logits) == 3
    for g, w in zip(got.pred_logits, want.pred_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    for name in ("kept_idx", "dropped_idx"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        got.kept_idx_orig.numpy(), np.asarray(want.kept_idx_orig))
    # 16 patches -> K = 11, 7, 5
    assert got.features.shape == (B, 5, 64)


def test_unpruned_forward_matches_jax():
    student = JaxStudent(
        cfg=JaxModelConfig(**MODEL),
        pruning=JaxPruningConfig(small_predictor=True, **PRUNING),
    )
    want = jax.jit(lambda p, x: student.apply(
        {"params": p}, x, unpruned=True, collect_cls_attns=False))(
            _jax_params(True), jnp.asarray(_images()))
    model = _port(True, True)
    with torch.inference_mode():
        got = model(torch.from_numpy(_images()), unpruned=True, collect_cls_attns=False)
    np.testing.assert_allclose(
        got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=1e-4)
    assert got.features.shape == (B, 16, 64)
    assert got.pred_logits == () and got.kept_idx_orig is None


def test_unported_options_are_rejected():
    with pytest.raises(NotImplementedError, match="predictor_bn"):
        create_model("dynamic_vit_tiny_patch16_224_student", predictor_bn=True,
                     device="cpu")


@pytest.mark.parametrize("field", ["remat", "topk_num_samples", "initial_sigma",
                                   "differentiable_topk", "attn_selection_threshold"])
def test_fields_no_port_code_reads_are_refused(field):
    with pytest.raises(TypeError, match=field):
        create_model("dynamic_vit_tiny_patch16_224_student", device="cpu", **{field: 1})
