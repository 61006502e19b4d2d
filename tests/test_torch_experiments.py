"""Port parity of the experiment drivers: `losses.distill.kd_loss`,
`experiments.optimized_mask` (`sgd_step_lr`, `run_optimized_mask`),
`experiments.display_patch_drop`, `experiments.eval_imagenet` and
`experiments.parity_report`, against the JAX package's on the same weights,
images and draws (fp32 on the CPU, plain layers; each test states its
tolerance), and the entry points' refusal to run without a card unless
asked for the CPU.

The two packages draw different random numbers, so `run_optimized_mask`
gets the same numpy draws on both sides: the Gumbel uniforms through
`test_torch_deit.same_draws`, the mask logits' normals through the port's
`optimized_mask.standard_normal` and a stand-in for `jax.random` in the
JAX module (which then runs eagerly, so that each epoch draws anew).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import dense2sparse_vit_tpu.experiments.display_patch_drop as jax_dpd
import dense2sparse_vit_tpu.experiments.eval_imagenet as jax_eval
import dense2sparse_vit_tpu.experiments.optimized_mask as jax_om
import dense2sparse_vit_tpu.models.deit as jax_deit
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import deit_tiny as jax_deit_tiny
from dense2sparse_vit_tpu.losses.distill import kd_loss as jax_kd_loss
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent

import dense2sparse_vit_torch.experiments.display_patch_drop as dpd
import dense2sparse_vit_torch.experiments.eval_imagenet as port_eval
import dense2sparse_vit_torch.experiments.optimized_mask as om
import dense2sparse_vit_torch.experiments.parity_report as pr
import dense2sparse_vit_torch.models.deit as port_deit
from dense2sparse_vit_torch.core import ModelConfig
from dense2sparse_vit_torch.losses import kd_loss
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_deit import build, same_draws
from test_torch_ops import random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=2, num_classes=10)
N = 16


def _images(n=4, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


# ---- kd_loss and the optimizer ---------------------------------------------


@pytest.mark.parametrize("temperature,epoch,keep_shape", [(1.0, 3.0, (4, 16)),
                                                          (2.0, 30.0, (4, 16, 1))])
def test_kd_loss_and_its_gradient_match_jax(temperature, epoch, keep_shape):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((4, 10)).astype(np.float32)
    t = rng.standard_normal((4, 10)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    keep = rng.random(keep_shape).astype(np.float32)

    def jax_fn(s, keep):
        return jax_kd_loss(s, jnp.asarray(t), jnp.asarray(y), keep, epoch,
                           temperature=temperature)

    (want, wm), (wgs, wgk) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(s), jnp.asarray(keep))
    ts, tk = torch.tensor(s, requires_grad=True), torch.tensor(keep, requires_grad=True)
    got, gm = kd_loss(ts, torch.from_numpy(t), torch.from_numpy(y), tk, epoch,
                      temperature=temperature)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-6)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k].detach()), float(wm[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(wgs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(wgk), rtol=1e-6, atol=1e-6)


def test_sgd_step_lr_matches_optax_over_25_counts():
    """The same gradients through both for 25 updates (the lr halves at
    counts 10 and 20): the parameters agree after every update."""
    g = np.random.default_rng(2).standard_normal((25, 6)).astype(np.float32)
    tx = jax_om.sgd_step_lr()
    p = jnp.zeros(6)
    state = tx.init(p)
    w = torch.zeros(6, requires_grad=True)
    opt, sched = om.sgd_step_lr([w])
    for i in range(25):
        upd, state = tx.update(jnp.asarray(g[i]), state, p)
        p = optax.apply_updates(p, upd)
        assert opt.param_groups[0]["lr"] == 0.5 ** (i // 10)
        w.grad = torch.from_numpy(g[i])
        opt.step()
        sched.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), rtol=1e-6, atol=1e-6)


# ---- optimized_mask ----------------------------------------------------------


def test_run_optimized_mask_matches_jax():
    """Depth 3, C = 64, patch 8, 32 px, mask_block 1, 3 epochs, the same
    weights, mask-logit init and Gumbel uniforms: the histories agree
    within 1e-4 relative, and the logits moved."""
    _, sv, _ = build(jax_deit.MaskedDistilledDeiT, port_deit.MaskedDistilledDeiT, SMALL,
                     mask_block=1)
    _, tv, _ = build(jax_deit.DistilledDeiT, port_deit.DistilledDeiT, SMALL, seed=2)
    x = _images()
    y = np.array([1, 4, 7, 9])
    normals = np.random.default_rng(3).standard_normal((N, 2)).astype(np.float32)
    fake = types.SimpleNamespace(
        random=types.SimpleNamespace(PRNGKey=jax.random.PRNGKey, fold_in=jax.random.fold_in,
                                     normal=lambda key, shape: jnp.asarray(normals)),
        lax=jax.lax, nn=jax.nn, jit=lambda f: f, value_and_grad=jax.value_and_grad)
    saved_jax, saved_normal = jax_om.jax, om.standard_normal
    jax_om.jax = fake
    om.standard_normal = lambda shape, generator: torch.from_numpy(normals)
    try:
        with same_draws(5):
            _, want = jax_om.run_optimized_mask(
                jnp.asarray(x), jnp.asarray(y), num_epochs=3, cfg=JaxModelConfig(**SMALL),
                student_params=sv["params"], teacher_params=tv["params"], mask_block=1)
            logits, got = om.run_optimized_mask(
                x, y, num_epochs=3, cfg=ModelConfig(**SMALL),
                student_params=state_dict_from_jax(sv), teacher_params=state_dict_from_jax(tv),
                mask_block=1, device="cpu")
    finally:
        jax_om.jax, om.standard_normal = saved_jax, saved_normal
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)
    init = normals * np.sqrt(2.0 / (N + 2))
    assert not np.allclose(logits.numpy(), init)


def test_optimized_mask_writes_its_panels(tmp_path):
    x, y = _images(2), np.array([0, 3])
    _, hist = om.run_optimized_mask(x, y, num_epochs=3, cfg=ModelConfig(**SMALL), mask_block=1,
                                    save_dir=str(tmp_path), viz_every=2, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["optimized_mask_epoch_0.png",
                                            "optimized_mask_epoch_2.png"]
    assert all(np.isfinite(v) for h in hist for v in h.values())


# ---- display_patch_drop --------------------------------------------------------


def test_patch_drop_masks_and_grids_match_jax(tmp_path, monkeypatch):
    """A small DeiT on both sides: the 18 keep masks equal, the masked
    panels within 1e-6, the same file names."""
    jm, variables, pm = build(jax_deit.DeiT, port_deit.DeiT, dict(SMALL, depth=2))
    x = _images(3, seed=4)
    attn = np.asarray(jm.apply(variables, jnp.asarray(x), return_selfattention=True))
    spatial = attn.mean(1)[:, 1:]
    spatial = spatial / spatial.sum(-1, keepdims=True)
    got_spatial = dpd.attention_scores(pm.eval(), torch.from_numpy(x))
    np.testing.assert_allclose(got_spatial, spatial, rtol=1e-5, atol=1e-7)
    for (fg, rate), keep in dpd.patch_drop_masks(got_spatial).items():
        np.testing.assert_array_equal(keep, jax_dpd.attention_keep_mask(spatial, rate, fg))
    panels = {}

    def capture(side):
        def fn(masked, path, **kw):
            panels.setdefault(side, []).append((os.path.basename(path), masked))
            return path
        return fn

    monkeypatch.setattr(jax_dpd, "save_image_grid", capture("jax"))
    monkeypatch.setattr(dpd, "save_image_grid", capture("port"))
    jax_dpd.generate_patch_drop_masked_image(jm, variables, jnp.asarray(x), str(tmp_path),
                                             patch_size=8)
    dpd.generate_patch_drop_masked_image(pm, torch.from_numpy(x), str(tmp_path), patch_size=8)
    assert len(panels["port"]) == 18
    assert sorted(n for n, _ in panels["port"]) == sorted(n for n, _ in panels["jax"])
    want = dict(panels["jax"])
    for name, masked in panels["port"]:
        np.testing.assert_allclose(masked, want[name], rtol=0, atol=1e-6)


def test_shape_token_rows_are_the_attention_rows():
    """The plain row display_patch_drop takes for the distillation token is the
    block's softmax row: at row 0 it is the CLS row the model returns."""
    _, _, pm = build(jax_deit.DeiT, port_deit.DeiT, dict(SMALL, depth=2))
    x = torch.from_numpy(_images(2, seed=6))
    with torch.no_grad():
        want = pm.eval()(x, return_selfattention=True)
        got = dpd._shape_token_rows(pm, x, row=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)


def test_display_patch_drop_cli_writes_18_grids(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(7)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(d / f"{i}.jpg")
    ds = dpd.UnlabeledImageFolder(str(d))
    assert len(ds) == 3 and ds.files == ["0.jpg", "1.jpg", "2.jpg"]
    x = dpd.load_panel(str(d), 2, "cpu")
    assert tuple(x.shape) == (2, 224, 224, 3)
    with pytest.raises(FileNotFoundError):
        dpd.UnlabeledImageFolder(str(tmp_path / "in" / ".."))


# ---- eval_imagenet -------------------------------------------------------------


@pytest.fixture(scope="module")
def val_folder(tmp_path_factory):
    """8 JPEGs of 64 px in two classes."""
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(0)
    for c in range(2):
        d = root / f"n{c:08d}"
        d.mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
                d / f"{i}.jpeg")
    return str(root)


def _fake_deit_tiny(path, extra=None):
    """The DeiT-tiny .pth of tests/test_eval_harness.py (seeded random
    weights, reference key layout), with `extra` keys added."""
    torch.manual_seed(0)
    d, depth = 192, 12
    sd = {"cls_token": torch.randn(1, 1, d) * 0.02, "pos_embed": torch.randn(1, 197, d) * 0.02,
          "patch_embed.proj.weight": torch.randn(d, 3, 16, 16) * 0.02,
          "patch_embed.proj.bias": torch.zeros(d), "norm.weight": torch.ones(d),
          "norm.bias": torch.zeros(d), "head.weight": torch.randn(1000, d) * 0.02,
          "head.bias": torch.zeros(1000)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": torch.ones(d), p + "norm1.bias": torch.zeros(d),
            p + "attn.qkv.weight": torch.randn(3 * d, d) * 0.02,
            p + "attn.qkv.bias": torch.zeros(3 * d),
            p + "attn.proj.weight": torch.randn(d, d) * 0.02, p + "attn.proj.bias": torch.zeros(d),
            p + "norm2.weight": torch.ones(d), p + "norm2.bias": torch.zeros(d),
            p + "mlp.fc1.weight": torch.randn(4 * d, d) * 0.02,
            p + "mlp.fc1.bias": torch.zeros(4 * d),
            p + "mlp.fc2.weight": torch.randn(d, 4 * d) * 0.02, p + "mlp.fc2.bias": torch.zeros(d),
        })
    sd.update(extra or {})
    torch.save({"model": sd}, path)
    return str(path)


def _logits_spies(monkeypatch):
    """Record the logits of every forward of `evaluate` on both sides:
    {unpruned: [(B, 1000) array, ...]} in batch order."""
    port, jax_side = {False: [], True: []}, {False: [], True: []}
    port_build, jax_build = port_eval.build_model, jax_eval.build_model

    def build_port(*a, **k):
        model, has_unpruned = port_build(*a, **k)

        def hook(mod, args, kwargs, out):
            port[kwargs.get("unpruned", False)].append(out.logits.detach().numpy().copy())
        model.register_forward_hook(hook, with_kwargs=True)
        return model, has_unpruned

    def build_jax(*a, **k):
        model, logits_fn, converter, has_unpruned = jax_build(*a, **k)

        def spy(params, images, unpruned=False):
            out = logits_fn(params, images, unpruned)
            jax.debug.callback(lambda v: jax_side[unpruned].append(np.asarray(v)), out)
            return out
        return model, spy, converter, has_unpruned

    monkeypatch.setattr(port_eval, "build_model", build_port)
    monkeypatch.setattr(jax_eval, "build_model", build_jax)
    return port, jax_side


def test_evaluate_matches_jax(val_folder, tmp_path, monkeypatch):
    """deit_tiny from the fake checkpoint, 8 images at B = 3 (a padded tail
    of one), fp32, plain layers: the same image count, the same pruned and
    unpruned top-1, and every batch's pruned and unpruned logits within
    1e-5. A DeiT checkpoint has no predictor keys: JAX keeps its PRNGKey(0)
    init, which the port's checkpoint carries as extra keys so that both
    sides run the same weights. The random head would put every image on a
    class past the labels 0 and 1 (top-1 0 on both sides, whatever the
    logits), so a head bias of 10 on classes 0 and 1 keeps the argmax
    there, and class 1's bias is moved by the median of the unpruned
    logits' class-0 minus class-1 margin over the 8 images (a first run),
    so that the argmax falls on either class by image."""
    kw = dict(arch="deit_tiny", imgnet_val_dir=val_folder, pruning_locs=(3, 6),
              keep_ratios=(0.7, 0.49), batch_size=3, dtype="float32",
              use_fused_attention=False)
    model, *_ = jax_eval.build_model("deit_tiny", (3, 6), (0.7, 0.49), "float32", False)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))["params"]
    pred = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(params).items()
            if k.startswith("score_predictor")}
    port, jax_side = _logits_spies(monkeypatch)
    bias = torch.zeros(1000)
    bias[:2] = 10.0
    port_eval.evaluate(checkpoint=_fake_deit_tiny(tmp_path / "p.pth", {**pred, "head.bias": bias}),
                       device="cpu", **kw)
    first = np.concatenate(port[True])[:8]
    bias[1] += float(np.median(first[:, 0] - first[:, 1]))
    port[False].clear()
    port[True].clear()
    want = jax_eval.evaluate(checkpoint=_fake_deit_tiny(tmp_path / "j.pth", {"head.bias": bias}),
                             **kw)
    got = port_eval.evaluate(checkpoint=_fake_deit_tiny(tmp_path / "p.pth",
                                                        {**pred, "head.bias": bias}),
                             device="cpu", **kw)
    assert got["images"] == want["images"] == 8
    for k in ("pruned_top1", "unpruned_top1"):
        assert 0 < want[k] < 1, want
        assert got[k] == want[k]
    for unpruned in (False, True):
        assert len(port[unpruned]) == len(jax_side[unpruned]) == 3
        np.testing.assert_allclose(np.concatenate(port[unpruned]),
                                   np.concatenate(jax_side[unpruned]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"unpruned={unpruned}")
    sd = port_eval.load_torch_checkpoint(str(tmp_path / "j.pth"))
    model, _ = port_eval.build_model("deit_tiny", (3, 6), (0.7, 0.49), "float32", False)
    sd["pos_embed"] = sd["pos_embed"][:, :50]  # a 7 x 7 grid: resized to 14 x 14
    loaded, skipped = port_eval.load_checkpoint_weights(model, {**sd, "extra.w": torch.ones(1)})
    assert skipped == ["extra.w"] and len(loaded) == len(sd)


# ---- parity_report --------------------------------------------------------------


class _JaxReference:
    """A stand-in for the reference torch student: JAX's student on the
    same weights, called on NCHW images, returning (logits,)."""

    def __init__(self, student, variables):
        self.run = jax.jit(lambda v, x: student.apply(v, x, collect_cls_attns=False).logits)
        self.variables = variables
        self.unpruned = False

    def __call__(self, xt):
        x = jnp.asarray(xt.permute(0, 2, 3, 1).numpy())
        return (torch.from_numpy(np.array(self.run(self.variables, x))),)


def test_parity_report_with_a_jax_reference(val_folder, monkeypatch):
    pruning = dict(pruning_locs=(3,), keep_ratios=(0.7,))
    student = JaxStudent(cfg=jax_deit_tiny(), pruning=JaxPruningConfig(**pruning))
    shapes = jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    params = random_like_tree(shapes["params"], seed=8)
    sd_full = {k: torch.from_numpy(np.array(v)) for k, v in state_dict_from_jax(params).items()}

    def load(arch, locs, ratios, ckpt, small, bn, loss_type, reference_dir):
        assert (arch, tuple(locs), ckpt) == ("deit_tiny", (3,), "ckpt.pth")
        return _JaxReference(student, {"params": params}), sd_full

    monkeypatch.setattr(pr, "_load_reference_student", load)
    report = pr.parity_report(arch="deit_tiny", ref_ckpt="ckpt.pth", imgnet_val_dir=val_folder,
                              batch_size=4, max_batches=1, device="cpu", **pruning)
    assert report["images"] == 4
    assert report["pruned_delta"] == 0
    assert report["first_batch_max_logit_delta"] < 1e-4
    assert {"port_pruned_top1", "port_dense_top1", "ref_pruned_top1"} <= set(report)
    json.dumps(report)


def test_parity_report_raises_without_the_reference(tmp_path):
    missing = str(tmp_path / "vit_models")
    with pytest.raises(FileNotFoundError, match="vit_models"):
        pr.parity_report(ref_ckpt="x.pth", reference_dir=missing, device="cpu")


# ---- the entry points and the card ----------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("entry", ["evaluate", "run_optimized_mask", "parity_report",
                                   "display_patch_drop"])
def test_entry_points_raise_without_a_card(entry, tmp_path):
    calls = {
        "evaluate": lambda: port_eval.evaluate(imgnet_val_dir=str(tmp_path)),
        "run_optimized_mask": lambda: om.run_optimized_mask(_images(1), [0]),
        "parity_report": lambda: pr.parity_report(ref_ckpt="x.pth"),
        "display_patch_drop": lambda: dpd.main(["--input-dir", str(tmp_path)]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
