"""Port parity at token widths off the 16-byte rules:
dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The JAX Pallas kernels take token rows of any width. The port's kernels
take rows of 16-byte multiples (C a multiple of 8 in bf16, of 16 in int8);
its entries pad any other width once (`ops.rowpad`: zero columns past C,
heads of d columns spread to dp, the hidden width rounded up, the
LayerNorms told the true width), the gather and scatter copy narrow rows
in narrower units, and the predictor kernel reads rows at a pitch rounded
up to 8 (`ops.predictor.pitched`). On the CPU each wrapper runs its plain
version at the true width; these tests hold the padded routes themselves,
with the plain versions standing in for the kernels at the padded widths,
against the Pallas kernels in interpret mode at C = 39 (three heads of 13,
hidden 156: odd C, units 19 / 9) and C = 104 (eight heads of 13: C % 16 =
8, units 52 / 26), B = 2, N = 13 and 24, on numpy inputs from a seed: the
gather, the scatter (the gather's backward), the block forward (plain,
policy and CLS rows) and backward with dPolicy, the int8 block and the
fused small predictor. Tolerance TOL: 1e-5 of the largest magnitude
compared (fp32 sums in other orders; the TPU kernels fold LN1 into the
weights); the int8 block within one code step of its last product. Then
the slice as a whole: a depth-2 student at each width, JAX's weights
carried across by `utils.convert`, its forward and one train step against
JAX's. On the card, `tests/test_torch_cuda.py -k row_widths` holds each
kernel at these widths against its plain version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.block as jax_block
import dense2sparse_vit_tpu.ops.pallas.gather as jax_gather
import dense2sparse_vit_tpu.ops.pallas.quant as jax_quant
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.nn.predictor import PredictorLG as JaxPredictorLG
from dense2sparse_vit_tpu.ops.pallas.predictor import fused_predictor_lg as jax_predictor
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.ops import rowpad
from dense2sparse_vit_torch.ops.block import (
    attention_max_tokens,
    padded_backward,
    padded_forward,
    transformer_block_backward_reference,
    transformer_block_reference,
)
from dense2sparse_vit_torch.ops.predictor import pitched, predictor_lg_reference
from dense2sparse_vit_torch.ops.quant import (
    padded_int8,
    quant_block_reference,
    quantize_block_params,
)
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_head_width import _KEYS, _close
from test_torch_ops import _block_params, load_numpy_state, random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_step import _grad_probe

B = 2
TOL = 1e-5
WIDTHS = {39: 3, 104: 8}  # C: heads (head width 13)


def _case(C, n, seed=0):
    """(JAX block params, the port's weight dict, x, g, keep policy) at
    width C with WIDTHS[C] heads, hidden 4 C."""
    p = _block_params(C, 4 * C, seed=seed + C)
    w = {_KEYS[k]: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
         for k, v in p.items()}
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    pol = (rng.random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return {k: jnp.asarray(v) for k, v in p.items()}, w, x, g, pol


def _layout(C, q=rowpad.QUANTUM):
    return rowpad.block_layout(C, WIDTHS[C], 4 * C, q)


def _route_forward(x, w, H, policy=None, eps=1e-6, cls=False):
    """The block's forward as `ops.block._launch_forward` takes it on the
    card: padded where the widths need it, the plain version at the padded
    widths (LayerNorms over the true width) standing in for the kernel."""
    C = x.shape[2]
    scale = (C // H) ** -0.5
    L = rowpad.block_layout(C, H, w["w1"].shape[0])

    def kernel(xp, wp):
        out = transformer_block_reference(xp, wp, H, scale, 1e-6, policy=policy, eps=eps,
                                          return_cls=cls, stages=True, ln_width=C)
        return (out[0], out[2], out[1]) if cls else (out[0], out[1], None)

    if L is None:
        return kernel(x, w)
    return padded_forward(x, w, L, kernel)


# ---- the layout ------------------------------------------------------------------------


@pytest.mark.parametrize("C,H,hidden,q,want", [
    (39, 3, 156, 8, (16, 48, 160)), (104, 8, 416, 8, None), (104, 8, 416, 16, (14, 112, 416)),
    (381, 3, 1524, 8, (128, 384, 1528)), (1016, 8, 4064, 16, (128, 1024, 4064)),
    (384, 6, 1536, 16, None), (380, 4, 1520, 8, (96, 384, 1520)),
])
def test_the_padded_layout(C, H, hidden, q, want):
    """Heads go to the narrowest dp whose H dp is a multiple of the
    quantum, the hidden width to a multiple of it; aligned widths take no
    padding; a padded head's attention ceilings are its true width's."""
    L = rowpad.block_layout(C, H, hidden, q)
    if want is None:
        assert L is None
        return
    assert (L.dp, L.Cp, L.hp) == want and L.Cp % q == 0 and L.hp % q == 0
    for policy in (False, True):
        assert attention_max_tokens(L.dp, policy=policy, backward=True) == attention_max_tokens(
            L.d, policy=policy, backward=True)


def test_pad_and_unpad_are_inverse_and_place_the_heads():
    """Head h's column j lands at h dp + j, zeros elsewhere; unpad takes
    exactly the true columns back, for every weight kind."""
    L = rowpad.block_layout(39, 3, 156)
    t = torch.arange(2 * 39, dtype=torch.float32).reshape(2, 39) + 1
    p = rowpad.pad(t, L, "heads")
    assert p.shape == (2, 48) and torch.equal(p[:, 16:29], t[:, 13:26])
    assert not p[:, 13:16].any() and not p[:, 45:].any()
    assert torch.equal(rowpad.unpad(p, L, "heads"), t)
    w = _case(39, 13)[1]
    wp = rowpad.pad_weights(w, L)
    assert wp["wqkv"].shape == (144, 48) and wp["w2"].shape == (48, 160)
    assert not wp["ln1_w"][39:].any() and not wp["wqkv"][13:16].any()
    back = rowpad.unpad_weights(wp, L)
    assert all(torch.equal(back[k], w[k]) for k in w)


# ---- each Pallas function against the port's route -----------------------------------


@pytest.mark.parametrize("C", sorted(WIDTHS))
def test_gather_and_scatter_match_pallas(C):
    """The gather bit for bit, and its backward (the scatter: repeats add,
    out-of-range indices add nothing) bit for bit, at rows of 39 and 104
    values (78 and 208 bytes in bf16)."""
    rng = np.random.default_rng(C)
    x = rng.standard_normal((B, 24, C)).astype(np.float32)
    g = rng.standard_normal((B, 17, C)).astype(np.float32)
    idx = rng.permutation(24)[:17][None].repeat(B, 0)
    idx[0, 1], idx[0, 5], idx[1, 0], idx[1, 8] = idx[0, 4], 40, -1, 24
    want, vjp = jax.vjp(lambda a: jax_gather.fused_gather_tokens(
        a, jnp.asarray(idx, jnp.int32), 8, True), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = ops.fused_gather_tokens(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("C", sorted(WIDTHS))
@pytest.mark.parametrize("n", [13, 24])
@pytest.mark.parametrize("mode", ["plain", "policy", "cls"])
def test_block_forward_route_matches_pallas(C, n, mode):
    """The padded route's output (and its CLS rows; policy mode at eps 0.1)
    against `fused_transformer_block` in interpret mode."""
    H = WIDTHS[C]
    jp, w, x, _, pol = _case(C, n)
    pol = pol if mode == "policy" else None
    if mode == "cls":
        want, want_cls = jax_block.fused_transformer_block(jnp.asarray(x), jp, H,
                                                           return_cls=True, interpret=True)
        got, _, got_cls = _route_forward(torch.from_numpy(x), w, H, cls=True)
        _close(got_cls, want_cls, TOL)
    else:
        want = jax_block.fused_transformer_block(
            jnp.asarray(x), jp, H, None if pol is None else jnp.asarray(pol), eps=0.1,
            interpret=True)
        got, _, _ = _route_forward(torch.from_numpy(x), w, H,
                                   None if pol is None else torch.from_numpy(pol), eps=0.1)
    _close(got, want, TOL)


@pytest.mark.parametrize("C", sorted(WIDTHS))
def test_block_backward_route_with_dpolicy_matches_pallas(C):
    """dx, the twelve gradients (the pads' taken off) and dPolicy (eps 0.1)
    of the padded route against `fused_transformer_block_backward` in
    interpret mode."""
    H = WIDTHS[C]
    jp, w, x, g, pol = _case(C, 24, seed=1)
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, H, jnp.asarray(pol), eps=0.1, interpret=True)
    xt, gt, pt = torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(pol)
    scale = (C // H) ** -0.5

    def kernel(xp, gp, wp):
        return transformer_block_backward_reference(xp, gp, wp, H, scale, 1e-6, policy=pt,
                                                    eps=0.1, ln_width=C)

    L = _layout(C)
    dx, dw, dpol = kernel(xt, gt, w) if L is None else padded_backward(xt, gt, w, L, kernel)
    _close(dx, dx_k, TOL)
    _close(dpol, dpol_k, TOL)
    for jk, pk in _KEYS.items():
        want = np.asarray(dp_k[jk])
        _close(dw[pk], want.T if want.ndim == 2 else want, TOL)


@pytest.mark.parametrize("C", sorted(WIDTHS))
def test_int8_block_route_matches_pallas(C):
    """The int8 block's padded route (both widths pad: 39 and 104 are no
    multiples of 16; heads of 13 go to 16 and 14) against
    `fused_transformer_block_int8` in interpret mode, within one code step
    of the last product."""
    H = WIDTHS[C]
    jp, w, x, _, _ = _case(C, 24, seed=4)
    want = jax_quant.fused_transformer_block_int8(jnp.asarray(x), jp, H, block_batch=2,
                                                  interpret=True)
    qw = quantize_block_params(w)
    L = _layout(C, rowpad.INT8_QUANTUM)
    scale = (C // H) ** -0.5
    got, st = padded_int8(torch.from_numpy(x), qw, L, lambda xp, qwp: quant_block_reference(
        xp, qwp, H, scale, 1e-6, stages=True, ln_width=C), stages=True)
    assert st["q1"].shape == (B, 24, C) and st["attn"].shape == (B, 24, C)
    step = st["s4"].max().item() * 127 * qw["s2"].max().item()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=step)


def _predictor_tree(C):
    """The small predictor's flax param tree at width C (units C -> C, C /
    2, C / 4), every leaf drawn by `random_like_tree`. Built by its shapes:
    the flax module's own unfused path cannot initialise at an odd C (its
    split broadcasts C - C // 2 pooled channels to C // 2)."""
    unit = (lambda i, o: {"norm": {"scale": np.zeros(i), "bias": np.zeros(i)},
                          "dense": {"kernel": np.zeros((i, o)), "bias": np.zeros(o)}})
    tree = {"in_0": unit(C, C), "out_0": unit(C, C // 2), "out_1": unit(C // 2, C // 4),
            "final_norm": {"scale": np.zeros(C // 4), "bias": np.zeros(C // 4)},
            "final_dense": {"kernel": np.zeros((C // 4, 1)), "bias": np.zeros(1)}}
    return random_like_tree(tree, seed=8 + C)


@pytest.mark.parametrize("C", sorted(WIDTHS))
def test_fused_predictor_route_matches_pallas(C):
    """The small predictor (units C -> C, C / 2, C / 4: 39, 19, 9 and 104,
    52, 26; the local half C // 2 wide, the pooled half the rest) read as
    the kernel reads it (`pitched`: rows at a pitch rounded up to 8, zeros
    past the true widths) against the Pallas kernel in interpret mode, and
    at C = 104 the flax module too."""
    rng = np.random.default_rng(C + 1)
    x = rng.standard_normal((B, 13, C)).astype(np.float32)
    params = _predictor_tree(C)
    want_kernel = jax_predictor(jnp.asarray(x), params, act="gelu", interpret=True)
    if C % 2 == 0:
        want, _ = JaxPredictorLG(embed_dim=C, small_predictor=True).apply(
            {"params": params}, jnp.asarray(x))
        _close(torch.from_numpy(np.array(want_kernel)), want, 1e-4)
    sd = state_dict_from_jax({"score_predictor_0": params})
    sd = {k[len("score_predictor.0."):]: v for k, v in sd.items()}
    port = load_numpy_state(PredictorLG(C, small_predictor=True), sd).eval()
    w = port.kernel_weights(torch.float32)
    assert [u[2].shape[0] for u in w["units"]] == [C, C // 2, C // 4]
    xp, wp = pitched(torch.from_numpy(x), w)
    assert xp.shape[2] % 8 == 0 and all(u[2].shape[1] % 8 == 0 for u in wp["units"])
    widths = [C] + [u[2].shape[0] for u in w["units"]]
    # the plain version reading the true columns back from the pitched copies
    read = {**wp, "units": [(lw, lb, wt[:, :widths[i]], b)
                            for i, (lw, lb, wt, b) in enumerate(wp["units"])],
            "final": (*wp["final"][:2], wp["final"][2][:, :widths[-1]], wp["final"][3])}
    with torch.no_grad():
        got = predictor_lg_reference(xp[..., :C], read)
    _close(got, want_kernel, 1e-4)


def test_the_entries_take_every_width():
    """No width check refuses a row of any size below the ceilings: the
    LayerNorm backward and the int8 rows name their ceilings alone."""
    from dense2sparse_vit_torch.ops.norm import LN_BWD_MAX_C, check_ln_width, ln_backward_takes
    from dense2sparse_vit_torch.ops.quant import ROW_MAX, check_rows, row_quantize_takes

    for c in (1, 12, 39, 104, 381, 1016, 1284, LN_BWD_MAX_C):
        assert ln_backward_takes(c) and row_quantize_takes(c)
        check_ln_width(c, "t")
        check_rows(c, 4 * c, "t")
    with pytest.raises(ValueError, match=f"at most {LN_BWD_MAX_C}"):
        check_ln_width(LN_BWD_MAX_C + 1, "t")
    with pytest.raises(ValueError, match=f"at most {ROW_MAX}"):
        check_rows(ROW_MAX + 1, 16, "t")


# ---- the slice as a whole: a depth-2 student at each width ---------------------------

STEPS_PER_EPOCH, EPOCH = 3, 6
TRAIN = dict(epochs=10, warmup_epochs=5)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.7,))


def _pruning(C):
    """The small predictor where JAX's flax module takes it (an even C: its
    unfused path, which the JAX student initialises and trains with,
    broadcasts C // 2 pooled channels), else the large one, whose split
    falls at 4 C."""
    return dict(PRUNING, small_predictor=C % 2 == 0)


def _model(C):
    return dict(img_size=32, patch_size=8, embed_dim=C, depth=2, num_heads=WIDTHS[C],
                num_classes=10)


def _images():
    return np.random.default_rng(93).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _params(C):
    imgs = jnp.asarray(_images()[:1])
    cfg = JaxModelConfig(**_model(C))
    student = JaxStudent(cfg=cfg, pruning=JaxPruningConfig(**_pruning(C)))
    s = jax.eval_shape(student.init, jax.random.PRNGKey(0), imgs)
    t = jax.eval_shape(JaxTeacher(cfg=cfg).init, jax.random.PRNGKey(1), imgs)
    return random_like_tree(s["params"], seed=94 + C), random_like_tree(t["params"], seed=95 + C)


@functools.lru_cache(maxsize=None)
def _jax_run(C):
    cfg = JaxExperimentConfig(model=JaxModelConfig(**_model(C)),
                              pruning=JaxPruningConfig(**_pruning(C)),
                              train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params, t_params = _params(C)
    imgs = jnp.asarray(_images())
    out = jax.jit(lambda p, x: student.apply({"params": p}, x, deterministic=True,
                                             collect_cls_attns=False))(params, imgs)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = step(state, t_params, imgs, jnp.asarray(_labels()),
                           jax.random.PRNGKey(3), jnp.float32(EPOCH))
    return ({"logits": np.asarray(out.logits), "kept": [np.asarray(k) for k in out.kept_idx]},
            {k: float(v) for k, v in metrics.items()}, state_dict_from_jax(probed.opt_state))


@pytest.mark.parametrize("C", sorted(WIDTHS))
def test_student_at_the_row_widths_matches_jax(C):
    """A `dynamic_vit_base_patch16_224_student` at C = 39 (the large
    predictor: units 156, 78, 39, 19, 9) and 104 (the small one: 104, 52,
    26), 16 patches pruned to 11 at block 1: the eval forward's
    logits within 1e-4 of their largest magnitude and the kept indices
    exact; one train step past warmup with the live teacher, its loss and
    metrics within 1e-5 and every gradient within 1e-4 of its tensor's
    largest magnitude (floored at 1e-3 of the model's largest)."""
    want_out, want_metrics, want_grads = _jax_run(C)
    kw = dict(device="cpu", use_fused_attention=True, **_model(C))
    student = load_numpy_state(
        create_model("dynamic_vit_base_patch16_224_student", **kw, **_pruning(C)),
        state_dict_from_jax(_params(C)[0]))
    teacher = load_numpy_state(create_model("dynamic_vit_base_patch16_224_teacher", **kw),
                               state_dict_from_jax(_params(C)[1]))
    assert student.cfg.embed_dim == C and student.score_predictor[0].use_fused
    x = torch.from_numpy(_images())
    with torch.no_grad():
        out = student.eval()(x, collect_cls_attns=False)
    _close(out.logits, want_out["logits"], 1e-4)
    for k, w in zip(out.kept_idx, want_out["kept"]):
        np.testing.assert_array_equal(k.numpy(), w)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student.train(), cfg.train, STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    got = make_train_step(student, teacher, opt, cfg)(x, torch.from_numpy(_labels()), EPOCH)
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
