"""Port parity past 800 tokens: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The Pallas kernels take any sequence length; on the card the port's width-64
attention core stops at `ops.block.SHORT_TOKENS` = 800 tokens and longer
sequences take the csrc/attention_hd.cuh pair, up to
`ops.block.attention_max_tokens`. Here, on the CPU, the wrappers run their
plain versions, which the card's kernels are held to by `chip_smoke.py`
phase 38; these tests hold the plain versions to JAX at N = 1025 (a 512-px
image at patch 16):

- the whole block both ways at B=1, in plain mode, in policy mode with
  dPolicy, and with its CLS rows, at C=128 with 2 heads (d = 64) and C=192
  with 2 heads (d = 96), against the Pallas kernels in interpret mode
  (`ops/pallas/block.py`'s forward and backward);
- the packed attention with its CLS rows both ways (the rows' cotangent
  folded in) against `ops/pallas/attention.py`'s forward and backward in
  interpret mode;
- the slice as a whole: the pruned student at img_size=512 (depth 4,
  C=128, 2 heads, keep 0.7/0.49/0.343 at blocks 1/2/3) with JAX's weights
  carried across by `utils.convert`, its logits, kept indices and
  pred_logits, and one train step's loss and gradients against JAX's
  `make_train_step`;
- the shape-acceptance function, which needs no card.

Inputs are seeded numpy in fp32, inside the JAX package's known limits
(|scaled logits| well under 30, no row whose every logit is strongly
negative: `ROADMAP.md` §3). Tolerances as the existing block tests take
them: 2e-4 on block outputs and gradients (the TPU kernel folds the
LayerNorm into the weights and reorders fp32 sums), 1e-5 on the CLS rows
and the packed core, relative to each tensor's largest magnitude where so
stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
import dense2sparse_vit_tpu.ops.pallas.block as jax_block
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
from dense2sparse_vit_torch.ops.attention import (
    fused_attention_backward_packed, fused_attention_packed)
from dense2sparse_vit_torch.ops.block import (
    SHORT_TOKENS, attention_max_tokens, check_tokens, fused_transformer_block,
    fused_transformer_block_backward, fused_transformer_block_cls, lse_is_float4)
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, load_numpy_state, random_like_tree
from test_torch_policy import PORT_KEYS, _port_weights
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_step import _grad_probe

N = 1025  # a 512-px image at patch 16, with the CLS token
WIDTHS = ((128, 2), (192, 2))  # (C, heads): head widths 64 and 96
MATRICES = ("wqkv", "wproj", "w1", "w2")


def _rel_close(got, want, tol, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=name)


def _case(c, seed):
    """Block params (MLP ratio 4), x, the cotangent g and a (1, N) keep
    policy, seeded."""
    p = _block_params(c, 4 * c, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((1, N, c)).astype(np.float32)
    g = rng.standard_normal((1, N, c)).astype(np.float32)
    pol = (rng.random((1, N)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return p, x, g, pol


# ---- the whole block -------------------------------------------------------


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("c,heads", WIDTHS)
def test_block_forward_and_cls_rows_match_pallas_past_800(c, heads, policy):
    """The block output within 2e-4 and its (B, H, N) CLS rows within 1e-5
    (each ~1/N) against the Pallas forward kernel, in plain and policy mode
    (eps 0.1, where the smoothing shows)."""
    p, x, _, pol = _case(c, seed=c + policy)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jpol = jnp.asarray(pol) if policy else None
    out_k, cls_k = jax_block.fused_transformer_block(
        jnp.asarray(x), jp, heads, jpol, eps=0.1, return_cls=True, exact=True, interpret=True)
    w, xt = _port_weights(p), torch.from_numpy(x)
    pt = torch.from_numpy(pol) if policy else None
    out = fused_transformer_block(xt, w, heads, pt, eps=0.1)
    out_c, cls = fused_transformer_block_cls(xt, w, heads, pt, eps=0.1)
    assert torch.equal(out, out_c) and cls.shape == (1, heads, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_k), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_k), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("c,heads", WIDTHS)
def test_block_backward_matches_pallas_past_800(c, heads, policy):
    """dx, the twelve gradients and, in policy mode, dPolicy within 2e-4 of
    each tensor's largest magnitude against the Pallas backward kernel."""
    p, x, g, pol = _case(c, seed=c + 10 + policy)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jpol = jnp.asarray(pol) if policy else None
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, heads, jpol, eps=0.1, interpret=True)
    pt = torch.from_numpy(pol) if policy else None
    dx, dw, dpol = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), _port_weights(p), heads, pt, eps=0.1)
    _rel_close(dx.numpy(), dx_k, 2e-4, "dx")
    for k in p:
        want = np.asarray(dp_k[k])
        _rel_close(dw[PORT_KEYS[k]].numpy(), want.T if k in MATRICES else want, 2e-4, k)
    if policy:
        _rel_close(dpol.numpy(), dpol_k, 2e-4, "dpolicy")
    else:
        assert dpol is None


# ---- the packed attention ---------------------------------------------------


def _qkv_case(seed=60, c=128, heads=2, b=1):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, N, 3 * c)).astype(np.float32)
    g = rng.standard_normal((b, N, c)).astype(np.float32)
    gcls = rng.standard_normal((b, heads, N)).astype(np.float32)
    return qkv, g, gcls


def test_packed_attention_with_cls_rows_both_ways_past_800():
    """The packed core's output within 1e-5 and its CLS rows within 1e-5 of
    the Pallas forward; dqkv with the CLS rows' cotangent folded in within
    1e-4 of its largest magnitude of the Pallas backward (fp32 sums over
    1025 keys in another order)."""
    heads = 2
    qkv, g, gcls = _qkv_case()
    want_out, want_cls = jax_attention.fused_attention_packed(
        jnp.asarray(qkv), heads, None, exact=True, return_cls=True, interpret=True)
    out, cls = fused_attention_packed(torch.from_numpy(qkv), heads, return_cls=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=1e-5, atol=1e-5)
    want = jax_attention.fused_attention_backward_packed(
        jnp.asarray(qkv), jnp.asarray(g), heads, gcls=jnp.asarray(gcls), interpret=True)
    got = fused_attention_backward_packed(torch.from_numpy(qkv), torch.from_numpy(g), heads,
                                          gcls=torch.from_numpy(gcls))
    _rel_close(got.numpy(), want, 1e-4, "dqkv")


# ---- the slice as a whole: the pruned student at 512 px ----------------------

MODEL = dict(img_size=512, patch_size=16, embed_dim=128, depth=4, num_heads=2, num_classes=10)
PRUNING = dict(pruning_locs=(1, 2, 3), keep_ratios=(0.7, 0.49, 0.343), small_predictor=True)
TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH, EPOCH, B = 3, 6, 2


def _images():
    return np.random.default_rng(70).standard_normal((B, 512, 512, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _params():
    imgs = jnp.asarray(_images()[:1])
    cfg = JaxModelConfig(**MODEL)
    student = JaxStudent(cfg=cfg, pruning=JaxPruningConfig(**PRUNING))
    s = jax.eval_shape(student.init, jax.random.PRNGKey(0), imgs)
    t = jax.eval_shape(JaxTeacher(cfg=cfg).init, jax.random.PRNGKey(1), imgs)
    return random_like_tree(s["params"], seed=71), random_like_tree(t["params"], seed=72)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's eval forward (logits, kept indices, pred_logits) and one train
    step's metrics and gradients, at the 512-px student."""
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
    return ({"logits": np.asarray(out.logits), "kept": [np.asarray(k) for k in out.kept_idx],
             "pred": [np.asarray(p) for p in out.pred_logits]},
            {k: float(v) for k, v in metrics.items()}, state_dict_from_jax(probed.opt_state))


def _port_models():
    params, t_params = _params()
    student = create_model("dynamic_vit_small_patch16_224_student", device="cpu",
                           use_fused_attention=True, **MODEL, **PRUNING)
    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=True, **MODEL)
    return (load_numpy_state(student, state_dict_from_jax(params)),
            load_numpy_state(teacher, state_dict_from_jax(t_params)))


def test_student_at_512_px_matches_jax():
    """1025 tokens pruned to 717, 502 and 352 (with the CLS token): the
    eval forward's logits within 1e-4 of their largest magnitude, the kept
    indices exact, each stage's pred_logits within 1e-4; one train step
    past warmup (the live teacher at 1025 tokens, both losses, backward)
    with its loss and metrics within 1e-5 and every gradient within 1e-4
    of its tensor's largest magnitude (floored at 1e-3 of the model's
    largest, as `test_torch_train_step.py` holds the predictors' shift-
    invariant biases)."""
    want_out, want_metrics, want_grads = _jax_run()
    student, teacher = _port_models()
    x = torch.from_numpy(_images())
    with torch.no_grad():
        out = student.eval()(x, collect_cls_attns=False)
    assert [k.shape[1] for k in out.kept_idx] == [716, 501, 351]
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


# ---- the shape-acceptance function --------------------------------------------


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [64, 96])
def test_the_kernels_take_long_sequences_up_to_a_stated_ceiling(d, backward, policy):
    """N = 801, 1025 and 3601 are taken at head widths 64 and 96 in either
    mode and direction; the ceiling (at least 3601) is taken and the next
    token refused, with a ValueError naming the limit and its cause."""
    limit = attention_max_tokens(d, policy=policy, backward=backward)
    assert limit >= 3601 and limit % 64 == 0
    for n in (1, 800, 801, 1025, 3601, limit):
        check_tokens(n, d, "t", policy=policy, backward=backward)
    for n in (0, limit + 1):
        with pytest.raises(ValueError, match=f"the kernels take 1 to {limit} .*shared memory"):
            check_tokens(n, d, "t", policy=policy, backward=backward)


def test_the_ceilings_follow_the_layouts():
    """The backward's ceiling is its rows' (16 B a query row), below the
    forward's (4 or 8 B a key); widths the kernels refuse have none; at
    d = 64 the long path starts past SHORT_TOKENS, elsewhere at once."""
    assert attention_max_tokens(64, backward=True) == 7168
    assert attention_max_tokens(96, backward=True) == 4544
    assert attention_max_tokens(128, backward=True) == 1920
    assert attention_max_tokens(64) == 45824 and attention_max_tokens(64, policy=True) == 22784
    assert all(attention_max_tokens(d) == 0 for d in (0, 257, 384))
    for d in range(1, 257):
        fwd, bwd = attention_max_tokens(d), attention_max_tokens(d, backward=True)
        assert SHORT_TOKENS < bwd <= fwd
        assert attention_max_tokens(d, policy=True) <= fwd
    assert not lse_is_float4(SHORT_TOKENS, 64, False) and lse_is_float4(SHORT_TOKENS + 1, 64, False)
    assert lse_is_float4(197, 96, False) and lse_is_float4(197, 64, True)
