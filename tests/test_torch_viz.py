"""Port parity of the visualization: `ops.topk.compose_kept_indices` and
`scatter_token_mask`, the numeric parts of `viz/attention_segmentation.py`
and the epoch-end hook `viz.hooks.epoch_visualize`, against the JAX
package's on seeded inputs. The port draws with Pillow where JAX draws with
matplotlib, so the pictures are checked by name, size and mode, the numbers
that go into them exactly (fp32 numpy on both sides: the same operations)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dense2sparse_vit_tpu.viz.attention_segmentation as jax_viz
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.ops.topk import compose_kept_indices as jax_compose
from dense2sparse_vit_tpu.ops.topk import scatter_token_mask as jax_scatter
from dense2sparse_vit_tpu.viz.hooks import epoch_visualize as jax_epoch_visualize

import dense2sparse_vit_torch.viz.attention_segmentation as viz
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.ops import compose_kept_indices, scatter_token_mask
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from dense2sparse_vit_torch.viz import epoch_visualize
from test_torch_ops import load_numpy_state, random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2, num_classes=10)
N = 16  # patches


def _chain(rng, B=3):
    """Stage-local kept indices of three stages over N = 16 tokens."""
    stages, n = [], N
    for k in (11, 7, 5):
        stages.append(np.sort(np.stack([rng.permutation(n)[:k] for _ in range(B)]), -1))
        n = k
    return stages


def test_compose_and_scatter_match_jax():
    stages = _chain(np.random.default_rng(0))
    got = compose_kept_indices([torch.from_numpy(s) for s in stages])
    want = jax_compose([jnp.asarray(s) for s in stages])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = scatter_token_mask(got, N)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_scatter(want, N)))
    assert mask.dtype == torch.float32 and mask.sum(-1).tolist() == [5.0] * 3


def test_numeric_viz_functions_match_jax():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.denormalize(images), jax_viz.denormalize(images))
    attn = rng.random((3, N)).astype(np.float32)
    for thr in (0.3, 0.6, 0.9):
        np.testing.assert_array_equal(viz.get_attention_masks(attn, thr, patch_size=8),
                                      jax_viz.get_attention_masks(attn, thr, patch_size=8))
    keep = (rng.random((3, N)) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(viz.generate_patch_mask(keep, 8),
                                  jax_viz.generate_patch_mask(keep, 8))
    other = (rng.random((3, N)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(viz.get_jaccard_similarity(keep, other),
                                  jax_viz.get_jaccard_similarity(keep, other))
    ratios = rng.random(50)
    np.testing.assert_array_equal(viz.dynamic_keep_ratio_hist(ratios),
                                  np.histogram(ratios, bins=20, range=(0, 1))[0])
    cls = rng.random((2, 4, 2, N)).astype(np.float32)
    for got, li in zip(viz.attention_histogram_counts(cls, 30), range(4)):
        np.testing.assert_array_equal(got, np.histogram(cls[:, li].ravel(), bins=30)[0])


def test_patch_drop_panel_is_jax_display_arithmetic(tmp_path, monkeypatch):
    """The masked panel the port draws is the array JAX hands to its grid
    writer (captured there), with and without the score overlay."""
    rng = np.random.default_rng(2)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    keep = (rng.random((4, N)) > 0.5).astype(np.float32)
    scores = rng.random((4, N)).astype(np.float32)
    seen = {}
    monkeypatch.setattr(jax_viz, "save_image_grid",
                        lambda masked, path, **kw: seen.update(masked=masked, **kw) or path)
    for s in (None, scores):
        jax_viz.display_patch_drop(images, keep, str(tmp_path / "j.png"), patch_scores=s,
                                   correct=np.array([1, 0, 1, 1], bool), patch_size=8)
        np.testing.assert_array_equal(viz.patch_drop_panel(images, keep, s, 8), seen["masked"])
    path = viz.display_patch_drop(images, keep, str(tmp_path / "p.png"), patch_scores=scores,
                                  correct=np.array([1, 0, 1, 1], bool), patch_size=8)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size[0] > 4 * 32


def test_head_maps_and_visualize_heads_match_jax(tmp_path):
    """The padded per-layer maps are JAX's (captured at its imshow calls);
    widths no prefix of the chain maps raise ValueError on both sides."""
    rng = np.random.default_rng(3)
    stages = _chain(rng, B=2)
    widths = [N, N, 11, 7, 5]
    attns = [rng.random((2, 2, w)).astype(np.float32) for w in widths]
    locs = (2, 3, 4)
    rows = viz.head_maps(attns, stages, num_patches=N, pruning_locs=locs)
    shown = []
    import matplotlib.axes

    real = matplotlib.axes.Axes.imshow

    def imshow(self, a, *args, **kw):
        shown.append(np.asarray(a))
        return real(self, a, *args, **kw)

    matplotlib.axes.Axes.imshow = imshow
    try:
        jax_viz.visualize_heads(attns, str(tmp_path / "j.png"), kept_idx_per_stage=stages,
                                num_patches=N, pruning_locs=locs)
    finally:
        matplotlib.axes.Axes.imshow = real
    np.testing.assert_array_equal(np.stack([m.reshape(-1) for r in rows for m in r]),
                                  np.stack([a.reshape(-1) for a in shown]))
    path = viz.visualize_heads(attns, str(tmp_path / "p.png"), kept_idx_per_stage=stages,
                               num_patches=N, pruning_locs=locs)
    assert os.path.exists(path)
    # the width-based fallback composes the same chain here
    fallback = viz.head_maps(attns, stages, num_patches=N)
    for a, b in zip(rows, fallback):
        np.testing.assert_array_equal(a, b)
    bad = attns[:2] + [rng.random((2, 2, 9)).astype(np.float32)]
    for fn in (viz.visualize_heads, jax_viz.visualize_heads):
        with pytest.raises(ValueError, match="cannot map layer 2"):
            fn(bad, str(tmp_path / "x.png"), kept_idx_per_stage=stages, num_patches=N)


@pytest.mark.parametrize("threshold", [None, 0.4])
def test_epoch_visualize_from_both_students(tmp_path, threshold):
    """The port student and the JAX student on the same weights: the same
    files, from the same keep mask (top-k: the composed kept indices;
    threshold: the last stage's mask) and the same overlay scores."""
    pruning = dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49),
                   patch_score_threshold=threshold)
    jm = JaxStudent(cfg=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**pruning))
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    params = random_like_tree(shapes["params"], seed=5)
    jout = jax.jit(lambda p, im: jm.apply({"params": p}, im))(params, jnp.asarray(x))
    pm = create_model("dynamic_vit_small_patch16_224_student", device="cpu", **MODEL,
                      **pruning)
    pm = load_numpy_state(pm, state_dict_from_jax(params)).eval()
    with torch.no_grad():
        pout = pm(torch.from_numpy(x))
    labels = np.array([1, 2, 3])
    seen = {}

    def capture(name):
        def fn(images, keep_mask, save_path, patch_scores=None, correct=None, **kw):
            seen[name] = (keep_mask, patch_scores, correct)
            return save_path
        return fn

    kw = dict(labels=labels, patch_size=8, visualize_cls_attn_evo=True, pruning_locs=(1, 2))
    got = epoch_visualize(x, pout, N, str(tmp_path / "port"), 3, **kw)
    want = jax_epoch_visualize(x, jout, N, str(tmp_path / "jax"), 3, **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert os.path.basename(got[0]) == "patch_drop_epoch_3.png"
    assert all(os.path.exists(p) for p in got)
    import dense2sparse_vit_torch.viz.hooks as hooks
    import dense2sparse_vit_tpu.viz.hooks as jax_hooks

    saved = hooks.display_patch_drop, jax_hooks.display_patch_drop
    hooks.display_patch_drop, jax_hooks.display_patch_drop = capture("port"), capture("jax")
    try:
        epoch_visualize(x, pout, N, str(tmp_path / "port"), 3, labels=labels, patch_size=8)
        jax_epoch_visualize(x, jout, N, str(tmp_path / "jax"), 3, labels=labels, patch_size=8)
    finally:
        hooks.display_patch_drop, jax_hooks.display_patch_drop = saved
    np.testing.assert_array_equal(seen["port"][0], seen["jax"][0])
    np.testing.assert_allclose(seen["port"][1], seen["jax"][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(seen["port"][2], seen["jax"][2])
