"""Port parity past ViT-B's width: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The Pallas kernels take any model width. On the card every backward entry
of the port's block kernels runs csrc/norm.cu's LayerNorm backward, which
takes rows of a multiple of 8 values up to `ops.norm.LN_BWD_MAX_C` (past
768 on a row spread over a CTA), and the int8 block quantizes rows of up to
`ops.quant.ROW_MAX` values (past 4096 a CTA a row). Here, on the CPU, the
wrappers run their plain versions, which the card's kernels are held to by
`chip_smoke.py` phase 39; these tests hold the plain versions to JAX at the
widths of ViT-L/16 and ViT-H/14 (the ViT paper, Table 1):

- the whole block's backward at C = 1280, 16 heads (d = 80), hidden 5120,
  B = 1, N = 17, in plain mode and in policy mode with dPolicy, against
  `ops/pallas/block.py`'s backward in interpret mode;
- the MLP half both ways at C = 1024, hidden 4096, against
  `ops/pallas/mlp.py` in interpret mode;
- the int8 block at C = 1280, hidden 5120, against `ops/pallas/quant.py`
  in interpret mode and JAX's `_ref_quant_block`;
- the slice as a whole: a ViT-H/14-width student at depth 2 (patch 14,
  56 px: 17 tokens, keep 0.7 at block 1) with JAX's weights carried across
  by `utils.convert`: its logits, kept indices and pred_logits, one train
  step's loss and gradients against JAX's `make_train_step`, and the int8
  student's kept indices and eval logits against JAX's int8 student
  (Pallas in interpret mode);
- the shape-acceptance functions, which need no card.

Inputs are seeded numpy in fp32. Tolerances as the narrower tests take
them: 2e-4 of each tensor's largest magnitude on the block backward (the
TPU kernel folds the LayerNorm into the weights and reorders fp32 sums),
1e-5 / 1e-4 on the MLP half's output / gradients, one code step on the
int8 block against the Pallas kernel, 1e-4 on the student's logits and
gradients, 1e-2 on the int8 student's logits (code flips: see its test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.block as jax_block
import dense2sparse_vit_tpu.ops.pallas.mlp as jax_mlp
import dense2sparse_vit_tpu.ops.pallas.quant as jax_quant
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.ops.block import fused_transformer_block_backward
from dense2sparse_vit_torch.ops.mlp import fused_mlp_residual, fused_mlp_residual_backward
from dense2sparse_vit_torch.ops.norm import LN_BWD_MAX_C, check_ln_width, ln_backward_takes
from dense2sparse_vit_torch.ops.quant import (
    ROW_MAX, check_rows, quant_block_reference, quantize_block_params, row_quantize_takes)
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, load_numpy_state, random_like_tree
from test_torch_policy import PORT_KEYS, _port_weights
from test_torch_quant import _jax_interpret
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_step import _grad_probe

C_H, HEADS_H, HIDDEN_H = 1280, 16, 5120  # ViT-H/14
C_L, HIDDEN_L = 1024, 4096  # ViT-L/16
N = 17
MATRICES = ("wqkv", "wproj", "w1", "w2")


def _rel_close(got, want, tol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


# ---- the whole block's backward at ViT-H's width ------------------------------


@pytest.mark.parametrize("policy", [False, True])
def test_block_backward_matches_pallas_at_vit_h_width(policy):
    """dx, the twelve gradients and, in policy mode (eps 0.1), dPolicy
    within 2e-4 of each tensor's largest magnitude against the Pallas
    backward kernel."""
    p = _block_params(C_H, HIDDEN_H, seed=80 + policy)
    rng = np.random.default_rng(81 + policy)
    x = rng.standard_normal((1, N, C_H)).astype(np.float32)
    g = rng.standard_normal((1, N, C_H)).astype(np.float32)
    pol = (rng.random((1, N)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, HEADS_H, jnp.asarray(pol) if policy else None,
        eps=0.1, interpret=True)
    dx, dw, dpol = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), _port_weights(p), HEADS_H,
        torch.from_numpy(pol) if policy else None, eps=0.1)
    _rel_close(dx.numpy(), dx_k, 2e-4, "dx")
    for k in p:
        want = np.asarray(dp_k[k])
        _rel_close(dw[PORT_KEYS[k]].numpy(), want.T if k in MATRICES else want, 2e-4, k)
    if policy:
        _rel_close(dpol.numpy(), dpol_k, 2e-4, "dpolicy")
    else:
        assert dpol is None


# ---- the MLP half at ViT-L's width ------------------------------------------------


def test_mlp_half_both_ways_matches_pallas_at_vit_l_width():
    """Output within 1e-5; dx and the six gradients (w1 / w2 against the JAX
    (in, out) layout transposed) within 1e-4 of each one's largest
    magnitude."""
    p = _block_params(C_L, HIDDEN_L, seed=82)
    rng = np.random.default_rng(83)
    x = rng.standard_normal((2, N, C_L)).astype(np.float32)
    g = rng.standard_normal((2, N, C_L)).astype(np.float32)
    jw = [p[k] for k in ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")]
    tw = [torch.from_numpy(w.T.copy() if w.ndim == 2 else w) for w in jw]
    want = jax_mlp.fused_mlp_residual(jnp.asarray(x), *map(jnp.asarray, jw), 1e-6, 8, True)
    got = fused_mlp_residual(torch.from_numpy(x), *tw, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jax_mlp.fused_mlp_residual_backward(jnp.asarray(x), jnp.asarray(g),
                                               *map(jnp.asarray, jw[:5]), interpret=True)
    got = fused_mlp_residual_backward(torch.from_numpy(x), torch.from_numpy(g), *tw[:5])
    for name, a, b in zip(("dx", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), got, want):
        b = np.asarray(b)
        _rel_close(a.numpy(), b.T if b.ndim == 2 and name.startswith("w") else b, 1e-4, name)


# ---- the int8 block at ViT-H's width ------------------------------------------------


def test_int8_block_matches_pallas_at_vit_h_width():
    """The plain int8 block (fc2's rows 5120 wide) against JAX
    `_ref_quant_block` and the Pallas kernel in interpret mode: within one
    code step of the output (the most one flipped code of the last product
    moves an element), and within 1e-5 of the reference."""
    p = _block_params(C_H, HIDDEN_H, seed=84)
    x = np.random.default_rng(85).standard_normal((2, N, C_H)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_ref = np.asarray(jax_quant._ref_quant_block(jnp.asarray(x), jp, HEADS_H))
    want_kernel = np.asarray(jax_quant.fused_transformer_block_int8(
        jnp.asarray(x), jp, HEADS_H, block_batch=2, interpret=True))
    qw = quantize_block_params(_port_weights(p))
    got, st = quant_block_reference(torch.from_numpy(x), qw, HEADS_H, (C_H // HEADS_H) ** -0.5,
                                    1e-6, stages=True)
    assert st["q4"].shape[-1] == HIDDEN_H
    step = st["s4"].max().item() * 127 * qw["s2"].max().item()
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


# ---- the slice as a whole: a ViT-H/14-width student at depth 2 ----------------------

MODEL = dict(img_size=56, patch_size=14, embed_dim=C_H, depth=2, num_heads=HEADS_H,
             num_classes=10)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.7,), small_predictor=True)
TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH, EPOCH, B = 3, 6, 2


def _images():
    return np.random.default_rng(86).standard_normal((B, 56, 56, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _params():
    imgs = jnp.asarray(_images()[:1])
    cfg = JaxModelConfig(**MODEL)
    student = JaxStudent(cfg=cfg, pruning=JaxPruningConfig(**PRUNING))
    s = jax.eval_shape(student.init, jax.random.PRNGKey(0), imgs)
    t = jax.eval_shape(JaxTeacher(cfg=cfg).init, jax.random.PRNGKey(1), imgs)
    return random_like_tree(s["params"], seed=87), random_like_tree(t["params"], seed=88)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's eval forward (logits, kept indices, pred_logits), one train
    step's metrics and gradients, and the int8 student's eval logits and
    kept indices (its kernels in interpret mode)."""
    cfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**PRUNING),
                              train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params, t_params = _params()
    imgs = jnp.asarray(_images())
    out = jax.jit(lambda p, x: student.apply({"params": p}, x, deterministic=True,
                                             collect_cls_attns=False))(params, imgs)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = step(state, t_params, imgs, jnp.asarray(_labels()),
                           jax.random.PRNGKey(3), jnp.float32(EPOCH))
    int8 = JaxStudent(cfg=JaxModelConfig(use_fused_attention=True, quant="int8", **MODEL),
                      pruning=cfg.pruning)
    saved = [(m, n, getattr(m, n)) for m, n, _ in _jax_interpret()]
    try:
        for m, n, patched in _jax_interpret():
            setattr(m, n, patched)
        out8 = int8.apply({"params": params}, imgs, collect_cls_attns=False)
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)
    return ({"logits": np.asarray(out.logits), "kept": [np.asarray(k) for k in out.kept_idx],
             "pred": [np.asarray(p) for p in out.pred_logits],
             "int8_logits": np.asarray(out8.logits),
             "int8_kept": [np.asarray(k) for k in out8.kept_idx]},
            {k: float(v) for k, v in metrics.items()}, state_dict_from_jax(probed.opt_state))


def _port_student(**kw):
    model = create_model("dynamic_vit_base_patch16_224_student", device="cpu",
                         use_fused_attention=True, **MODEL, **PRUNING, **kw)
    return load_numpy_state(model, state_dict_from_jax(_params()[0]))


def test_vit_h_width_student_matches_jax():
    """16 patches pruned to 11 at block 1: the eval forward's logits within
    1e-4 of their largest magnitude, the kept indices exact, pred_logits
    within 1e-4; one train step past warmup with the live teacher, its loss
    and metrics within 1e-5 and every gradient within 1e-4 of its tensor's
    largest magnitude (floored at 1e-3 of the model's largest, as
    `test_torch_train_step.py` holds the predictors' shift-invariant
    biases)."""
    want_out, want_metrics, want_grads = _jax_run()
    student = _port_student()
    teacher = load_numpy_state(
        create_model("dynamic_vit_base_patch16_224_teacher", device="cpu",
                     use_fused_attention=True, **MODEL), state_dict_from_jax(_params()[1]))
    x = torch.from_numpy(_images())
    with torch.no_grad():
        out = student.eval()(x, collect_cls_attns=False)
    assert [k.shape[1] for k in out.kept_idx] == [11]
    _rel_close(out.logits.numpy(), want_out["logits"], 1e-4, "logits")
    for i, (k, w) in enumerate(zip(out.kept_idx, want_out["kept"])):
        np.testing.assert_array_equal(k.numpy(), w, err_msg=f"kept {i}")
    for i, (p, w) in enumerate(zip(out.pred_logits, want_out["pred"])):
        _rel_close(p.numpy(), w, 1e-4, f"pred_logits {i}")
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student.train(), cfg.train, STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    ops.reset_launch_counts()
    got = make_train_step(student, teacher, opt, cfg)(x, torch.from_numpy(_labels()), EPOCH)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU tensors: plain versions
    assert set(got) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, atol=1e-5, err_msg=k)
    floor = 1e-3 * max(np.abs(v).max() for v in want_grads.values())
    labels = label_params(student)
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            continue
        scale = max(np.abs(want_grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_vit_h_width_int8_student_matches_jax():
    """The int8 student (every block's fc2 rows 5120 wide): its kept
    indices exact against JAX's int8 student's (Pallas in interpret mode),
    its logits within 1e-2 of their largest magnitude. Why 1e-2 and not the
    fp32 path's 1e-4: at this width some of a block's ~10^5 codes per
    quantization sit within fp32 rounding of a half step, and the two
    packages' attention cores round differently (the port's exact row-max
    softmax, JAX's clipped one: `ROADMAP.md` §3), so such a code flips; a
    flip in the attention output's or LN2's codes moves that token's row
    through fc1, GELU and fc2 (here one row of block 0, by up to 0.021; the
    logits by 3.3e-3 of their largest magnitude). The block on the same
    input is held to the Pallas kernel within one code step by
    `test_int8_block_matches_pallas_at_vit_h_width`."""
    want_out, _, _ = _jax_run()
    model = _port_student(quant="int8").eval()
    with torch.no_grad():
        out8 = model(torch.from_numpy(_images()), collect_cls_attns=False)
    for k, w in zip(out8.kept_idx, want_out["int8_kept"]):
        np.testing.assert_array_equal(k.numpy(), w)
    _rel_close(out8.logits.numpy(), want_out["int8_logits"], 1e-2, "int8 logits")


# ---- the shape-acceptance functions ------------------------------------------------


@pytest.mark.parametrize("c", [8, 200, 768, 776, 800, 1024, 1280, 1408, 1664, 2048])
def test_the_layernorm_backward_takes_every_multiple_of_8_up_to_its_ceiling(c):
    """Past 768 (ViT-L 1024, ViT-H 1280, ViT-g 1408, ViT-G 1664) and the
    widths below it that are no multiple of 32: every multiple of 8 up to
    the ceiling is taken."""
    assert LN_BWD_MAX_C >= 1664 and ln_backward_takes(c)
    check_ln_width(c, "t")


@pytest.mark.parametrize("c", [0, 12, 1284, LN_BWD_MAX_C + 8, 4096])
def test_the_layernorm_backward_names_its_ceiling(c):
    """Widths that are no multiple of 8 (12, 1284) are taken (their rows
    padded, `ops.rowpad`); no width and widths past the ceiling are refused
    with the ceiling named."""
    if 0 < c <= LN_BWD_MAX_C:
        assert ln_backward_takes(c)
        check_ln_width(c, "t")
        return
    assert not ln_backward_takes(c)
    with pytest.raises(ValueError, match=f"t: C={c}: .* at most {LN_BWD_MAX_C} values"):
        check_ln_width(c, "t")


@pytest.mark.parametrize("rows", [4096, 4104, 4112, 5120, 8192, 16384])
def test_the_int8_rows_are_taken_up_to_their_ceiling(rows):
    """Rows past ViT-L's MLP (4096): ViT-H's 5120, ViT-G's 8192, up to the
    ceiling of at least 16384 (ViT-e's MLP is 15360), by the row
    quantization (multiples of 8) and, where a multiple of 16 (the int8
    products' K), by the int8 block as the hidden width and as C."""
    assert ROW_MAX >= 16384 and row_quantize_takes(rows)
    if rows % 16 == 0:
        check_rows(1280, rows, "t")
        check_rows(rows, 1280, "t")


@pytest.mark.parametrize("c,hidden", [(1280, ROW_MAX + 16), (ROW_MAX + 16, 1280), (1288, 5120),
                                      (1280, 4104)])
def test_the_int8_rows_name_their_ceiling(c, hidden):
    """Rows past ROW_MAX are refused with the ceiling named; widths that are
    no multiple of 16 (1288, 4104: the int8 block's former rule) are taken,
    as are rows of any length up to the ceiling (4100)."""
    assert not row_quantize_takes(ROW_MAX + 8) and row_quantize_takes(4100)
    if max(c, hidden) <= ROW_MAX:
        check_rows(c, hidden, "t")
        return
    with pytest.raises(ValueError, match=f"rows of at most {ROW_MAX} values"):
        check_rows(c, hidden, "t")
