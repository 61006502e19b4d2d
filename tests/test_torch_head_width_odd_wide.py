"""Port parity at odd head widths and at widths past 128:
dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The JAX Pallas kernels take any head width (their ones-column padding
`max(8, 128 - d % 128)`, `ops/pallas/block.py:122`); the port's kernels
take every d from 1 to 256 (`ops.block.head_width`), odd widths with
gathered copies and element-wise stores, widths past 128 with one key block
a backward pass (csrc/attention_hd.cuh). On the CPU each wrapper runs its
plain version, which these tests hold against the Pallas kernels in
interpret mode at d = 13 (8 heads, C = 104: the row rule's C % 8 == 0 at an
odd width) and d = 160 (2 heads, C = 320), B = 2, N = 13 and 24, on numpy
inputs from a seed: the block forward in plain, policy and CLS-row mode,
its backward with dPolicy, the packed attention both ways with the CLS fold
(also at d = 129), the half-block forward and the int8 block. Tolerance TOL
(1e-5 of the largest magnitude compared: fp32 sums in another order, the
TPU kernels fold LN1 into the weights and pad N to 16); the int8 block
within one code step, as `test_torch_head_width.py` holds it. Then the
wrappers' width check on meta tensors, and the slice as a whole: a
depth-2 student at each width with JAX's weights carried across by
`utils.convert`, its forward and one train step's gradients against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
import dense2sparse_vit_tpu.ops.pallas.block as jax_block
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
from dense2sparse_vit_torch.ops.block import MAX_HEAD_DIM, attention_max_tokens, head_width
from dense2sparse_vit_torch.ops.quant import quant_block_reference, quantize_block_params
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_head_width import _KEYS, _close
from test_torch_ops import _block_params, load_numpy_state, random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_step import _grad_probe

B = 2
TOL = 1e-5
WIDTHS = {13: 8, 160: 2}  # head width: heads


def _case(d, n, seed=0, heads=None):
    """(JAX block params, the port's weight dict, x, g, keep policy, gcls)
    at head width d with `heads` heads (WIDTHS'), hidden 3 C."""
    H = heads or WIDTHS[d]
    C = H * d
    p = _block_params(C, 3 * C, seed=seed + d)
    w = {_KEYS[k]: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
         for k, v in p.items()}
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    pol = (rng.random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    gcls = rng.standard_normal((B, H, n)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in p.items()}, w, x, g, pol, gcls


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("n", [13, 24])
@pytest.mark.parametrize("mode", ["plain", "policy", "cls"])
def test_block_forward_matches_pallas(d, n, mode):
    """The block's output (and in "cls" mode its CLS rows, in policy mode
    at eps 0.1) against `fused_transformer_block` in interpret mode."""
    H = WIDTHS[d]
    jp, w, x, _, pol, _ = _case(d, n)
    pol = pol if mode == "policy" else None
    if mode == "cls":
        want, want_cls = jax_block.fused_transformer_block(jnp.asarray(x), jp, H,
                                                           return_cls=True, interpret=True)
        got, got_cls = ops.fused_transformer_block_cls(torch.from_numpy(x), w, H)
        _close(got_cls, want_cls, TOL)
    else:
        want = jax_block.fused_transformer_block(
            jnp.asarray(x), jp, H, None if pol is None else jnp.asarray(pol), eps=0.1,
            interpret=True)
        got = ops.fused_transformer_block(torch.from_numpy(x), w, H,
                                          None if pol is None else torch.from_numpy(pol),
                                          eps=0.1)
    _close(got, want, TOL)


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_block_backward_with_dpolicy_matches_pallas(d):
    """dx, the twelve gradients and dPolicy (eps 0.1) against
    `fused_transformer_block_backward` in interpret mode."""
    H = WIDTHS[d]
    jp, w, x, g, pol, _ = _case(d, 24, seed=1)
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, H, jnp.asarray(pol), eps=0.1, interpret=True)
    dx, dw, dpol = ops.fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), w, H, torch.from_numpy(pol), eps=0.1)
    _close(dx, dx_k, TOL)
    _close(dpol, dpol_k, TOL)
    for jk, pk in _KEYS.items():
        want = np.asarray(dp_k[jk])
        _close(dw[pk], want.T if want.ndim == 2 else want, TOL)


@pytest.mark.parametrize("d,heads", [(13, 8), (160, 2), (129, 2)])
@pytest.mark.parametrize("policy", [False, True])
def test_packed_attention_both_ways_match_pallas(d, heads, policy):
    """The packed core's output and CLS rows, then dqkv (and dPolicy) with
    the CLS rows' cotangent folded in, against the Pallas kernels."""
    C = heads * d
    rng = np.random.default_rng(d)
    qkv = rng.standard_normal((B, 24, 3 * C)).astype(np.float32)
    _, _, _, g, pol, gcls = _case(d, 24, seed=2, heads=heads)
    pol = pol if policy else None
    jpol = None if pol is None else jnp.asarray(pol)
    tp = None if pol is None else torch.from_numpy(pol)
    want, want_cls = jax_attention.fused_attention_packed(
        jnp.asarray(qkv), heads, jpol, eps=0.1, return_cls=True, exact=True, interpret=True)
    got, got_cls = ops.fused_attention_packed(torch.from_numpy(qkv), heads, tp, eps=0.1,
                                              return_cls=True)
    _close(got, want, TOL)
    _close(got_cls, want_cls, TOL)
    want = jax_attention.fused_attention_backward_packed(
        jnp.asarray(qkv), jnp.asarray(g), heads, policy=jpol, gcls=jnp.asarray(gcls), eps=0.1,
        interpret=True)
    got = ops.fused_attention_backward_packed(torch.from_numpy(qkv), torch.from_numpy(g), heads,
                                              policy=tp, gcls=torch.from_numpy(gcls), eps=0.1)
    for a, b in (zip(got, want) if policy else [(got, want)]):
        _close(a, b, TOL)


@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("policy", [False, True])
def test_half_block_forward_matches_pallas(d, policy):
    """x + proj(MHA(qkv(LN1 x))) and its CLS rows against
    `fused_attention_block` (exact softmax) in interpret mode."""
    H = WIDTHS[d]
    jp, w, x, _, pol, _ = _case(d, 13, seed=3)
    pol = pol if policy else None
    names = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj")
    want, want_cls = jax_attention.fused_attention_block(
        jnp.asarray(x), *(jp[k] for k in names), H, None if pol is None else jnp.asarray(pol),
        eps=0.1, return_cls=True, exact=True, interpret=True)
    got, got_cls = ops.fused_attention_block(
        torch.from_numpy(x), *(w[_KEYS[k]] for k in names), H,
        None if pol is None else torch.from_numpy(pol), eps=0.1, return_cls=True)
    _close(got, want, TOL)
    _close(got_cls, want_cls, TOL)


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_int8_block_matches_pallas(d):
    """The plain int8 block against `fused_transformer_block_int8` in
    interpret mode, within one code step of the last product."""
    H = WIDTHS[d]
    jp, w, x, _, _, _ = _case(d, 24, seed=4)
    want = jax_quant.fused_transformer_block_int8(jnp.asarray(x), jp, H, block_batch=2,
                                                  interpret=True)
    qw = quantize_block_params(w)
    got, st = quant_block_reference(torch.from_numpy(x), qw, H, d ** -0.5, 1e-6, stages=True)
    step = st["s4"].max().item() * 127 * qw["s2"].max().item()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=step)


def _meta_calls(C, H):
    """Every kernel wrapper's call on meta tensors (no data: the wrappers'
    checks are all that runs) at width C with H heads."""
    meta = torch.device("meta")
    x = torch.empty((B, 13, C), device=meta, dtype=torch.bfloat16)
    qkv = torch.empty((B, 13, 3 * C), device=meta, dtype=torch.bfloat16)
    hidden = 4 * C
    w = {"ln1_w": (C,), "ln1_b": (C,), "wqkv": (3 * C, C), "bqkv": (3 * C,),
         "wproj": (C, C), "bproj": (C,), "ln2_w": (C,), "ln2_b": (C,), "w1": (hidden, C),
         "b1": (hidden,), "w2": (C, hidden), "b2": (C,)}
    w = {k: torch.empty(s, device=meta) for k, s in w.items()}
    w6 = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")]
    return {
        "block": lambda: ops.fused_transformer_block(x, w, H),
        "block_cls": lambda: ops.fused_transformer_block_cls(x, w, H),
        "block_backward": lambda: ops.fused_transformer_block_backward(x, x, w, H),
        "packed": lambda: ops.fused_attention_packed(qkv, H),
        "packed_backward": lambda: ops.fused_attention_backward_packed(qkv, x, H),
        "half_block": lambda: ops.fused_attention_block(x, *w6, H),
        "half_block_backward": lambda: ops.fused_attention_block_backward(x, x, *w6[:5], H),
        "int8": lambda: ops.fused_transformer_block_int8(x, {}, H),
    }


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_the_new_widths_pass_the_wrappers_width_check(d):
    """At d = 13 (C = 104) and 160 (C = 320) every wrapper gets past the
    head-width check: the serving ops run their shape functions on meta
    tensors, the others stop later (at the device, which is neither CUDA
    nor CPU, or at the int8 block's missing weights); and the ceilings are
    at least 577 tokens both ways, so that a DeiT-B/16 of such heads trains
    at 384 px."""
    H = WIDTHS[d]
    assert head_width(H * d, H, "t") == d
    for name, call in _meta_calls(H * d, H).items():
        try:
            call()
        except (ValueError, KeyError) as err:
            assert "head width" not in str(err) and "C=" not in str(err), (name, err)
    for policy in (False, True):
        assert attention_max_tokens(d, policy=policy, backward=True) >= 577


def test_every_width_to_256_is_taken_and_the_rows_keep_their_rule():
    """Every d from 1 to MAX_HEAD_DIM = 256 passes `head_width` with its
    ceilings at least 577 tokens both ways; an odd width at a C that is no
    multiple of 8 (d = 13, 2 heads: C = 26), which the block entries' row
    rule refused, is taken: its rows are padded to the kernels' rule
    (`ops.rowpad`), so every wrapper gets past its width checks (to the
    device, which is neither CUDA nor CPU, or to the int8 block's missing
    weights); past 256 the head width is still refused."""
    assert MAX_HEAD_DIM == 256
    for d in range(1, MAX_HEAD_DIM + 1):
        assert head_width(3 * d, 3, "t") == d
        assert min(attention_max_tokens(d, policy=p, backward=True) for p in (False, True)) >= 577
    for name, call in _meta_calls(26, 2).items():
        try:
            call()
        except (ValueError, KeyError) as err:
            assert "head width" not in str(err) and "C=" not in str(err), (name, err)
    for name, call in _meta_calls(514, 2).items():
        with pytest.raises(ValueError, match="head width 257"):
            call()


# ---- the slice as a whole: a depth-2 student at each width ---------------------------

STEPS_PER_EPOCH, EPOCH = 3, 6
TRAIN = dict(epochs=10, warmup_epochs=5)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.7,), small_predictor=True)


def _model(d):
    H = WIDTHS[d]
    return dict(img_size=32, patch_size=8, embed_dim=H * d, depth=2, num_heads=H,
                num_classes=10)


def _images():
    return np.random.default_rng(90).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _params(d):
    imgs = jnp.asarray(_images()[:1])
    cfg = JaxModelConfig(**_model(d))
    student = JaxStudent(cfg=cfg, pruning=JaxPruningConfig(**PRUNING))
    s = jax.eval_shape(student.init, jax.random.PRNGKey(0), imgs)
    t = jax.eval_shape(JaxTeacher(cfg=cfg).init, jax.random.PRNGKey(1), imgs)
    return random_like_tree(s["params"], seed=91 + d), random_like_tree(t["params"], seed=92 + d)


@functools.lru_cache(maxsize=None)
def _jax_run(d):
    """JAX's eval forward (logits, kept indices) and one train step's
    metrics and gradients at head width d."""
    cfg = JaxExperimentConfig(model=JaxModelConfig(**_model(d)),
                              pruning=JaxPruningConfig(**PRUNING), train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params, t_params = _params(d)
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


@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_student_at_the_new_widths_matches_jax(d):
    """A `dynamic_vit_base_patch16_224_student` built with the width
    overrides JAX's `create_model` passes through (16 patches pruned to 11
    at block 1): the eval forward's logits within 1e-4 of their largest
    magnitude and the kept indices exact; one train step past warmup with
    the live teacher, its loss and metrics within 1e-5 and every gradient
    within 1e-4 of its tensor's largest magnitude (floored at 1e-3 of the
    model's largest, as `test_torch_wide.py` holds them)."""
    want_out, want_metrics, want_grads = _jax_run(d)
    kw = dict(device="cpu", use_fused_attention=True, **_model(d))
    student = load_numpy_state(
        create_model("dynamic_vit_base_patch16_224_student", **kw, **PRUNING),
        state_dict_from_jax(_params(d)[0]))
    teacher = load_numpy_state(create_model("dynamic_vit_base_patch16_224_teacher", **kw),
                               state_dict_from_jax(_params(d)[1]))
    assert student.blocks[0].attn.num_heads * d == student.cfg.embed_dim
    x = torch.from_numpy(_images())
    with torch.no_grad():
        out = student.eval()(x, collect_cls_attns=False)
    assert [k.shape[1] for k in out.kept_idx] == [11]
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
