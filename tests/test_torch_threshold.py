"""Port parity of threshold pruning: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The tiny student of `test_torch_train.py` with `patch_score_threshold` set,
in eval and train mode, against the JAX `DiffPruningStudent` (its Pallas
kernels in interpret mode, or its flax path), and one `make_train_step` in
threshold mode against the JAX step. fp32 on the CPU; each test states its
tolerance. The keep masks compare exactly: XLA's cumsum and torch's may
round differently, so the test checks that no prefix sum of a stage's
scores lies within 1e-5 of the threshold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.predictor as jax_predictor
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state
from test_torch_train import (
    MODEL, PRUNING, _images, _labels, _student_params, _teacher_params, _with_interpret)
from test_torch_train_step import STEPS_PER_EPOCH, TRAIN, _grad_probe, _set_schedule_count
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

THRESHOLD = 0.5
TPRUNING = dict(PRUNING, patch_score_threshold=THRESHOLD)


def _port_student(use_fused):
    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu",
                         use_fused_attention=use_fused, **MODEL, **TPRUNING)
    return load_numpy_state(model, state_dict_from_jax(_student_params()))


@functools.lru_cache(maxsize=None)
def _jax_forward(deterministic, fused):
    student = JaxStudent(cfg=JaxModelConfig(use_fused_attention=fused, **MODEL),
                         pruning=JaxPruningConfig(**TPRUNING))
    run = jax.jit(lambda p, x: student.apply({"params": p}, x, deterministic=deterministic,
                                             collect_cls_attns=False))
    # eval mode also reaches the predictor kernel: interpret mode for it too
    real = jax_predictor.fused_predictor_lg
    jax_predictor.fused_predictor_lg = functools.partial(real, interpret=True)
    try:
        return _with_interpret(lambda: run(_student_params(), jnp.asarray(_images())))
    finally:
        jax_predictor.fused_predictor_lg = real


def _assert_margin(model):
    """No stage's sorted prefix mass is within 1e-5 of the threshold."""
    seen = []
    hooks = [pred.register_forward_hook(lambda m, args, out: seen.append(out[1].detach()))
             for pred in model.score_predictor]
    try:
        with torch.no_grad():
            model(torch.from_numpy(_images()))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == 3
    for scores in seen:
        prefix = torch.cumsum(torch.sort(scores.float(), dim=-1).values, dim=-1)
        assert (prefix - THRESHOLD).abs().min() > 1e-5


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("jax_fused,port_fused", [(False, False), (True, True), (False, True)])
def test_threshold_student_matches_jax(deterministic, jax_fused, port_fused):
    """Eval (deterministic) and train mode: logits, features and pred_logits
    within 1e-4, the per-stage keep masks and the keep ratios exact; no
    token is gathered, every stage sees all N tokens."""
    want = _jax_forward(deterministic, jax_fused)
    model = _port_student(port_fused)
    model.train(not deterministic)
    _assert_margin(model)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(_images()), collect_cls_attns=False)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU tensors
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **tol)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **tol)
    assert len(got.pred_logits) == len(want.pred_logits) == 3
    for g, w in zip(got.pred_logits, want.pred_logits):
        assert g.shape == (2, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    assert len(got.keep_masks) == 3
    for g, w in zip(got.keep_masks, want.keep_masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.keep_mask.numpy(), np.asarray(want.keep_mask))
    np.testing.assert_array_equal(got.keep_ratios.numpy(), np.asarray(want.keep_ratios))
    assert got.kept_idx == () and got.kept_idx_orig is None
    # each stage replaces the previous stage's mask: they differ here
    assert not all(torch.equal(got.keep_masks[0], m) for m in got.keep_masks[1:])


def test_threshold_override_replaces_the_configured_threshold():
    model = _port_student(False).eval()
    x = torch.from_numpy(_images())
    with torch.no_grad():
        kept_all = model(x, threshold_override=0.0).keep_ratios
        kept_less = model(x, threshold_override=0.9).keep_ratios
    assert torch.equal(kept_all, torch.ones(2))
    assert (kept_less < 0.5).all()


def test_unpruned_threshold_student_runs_plain_blocks(monkeypatch):
    import dense2sparse_vit_torch.nn.layers as port_layers

    policies = []
    real = port_layers.Block.forward
    monkeypatch.setattr(port_layers.Block, "forward",
                        lambda self, x, policy=None, **k: policies.append(policy) or
                        real(self, x, policy, **k))
    model = _port_student(True).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_images()), unpruned=True)
        assert all(p is None for p in policies) and out.keep_masks == ()
        policies.clear()
        model(torch.from_numpy(_images()))
    # blocks 0 plain; blocks 1-3 (from the first stage on) with the policy
    assert [p is None for p in policies] == [True, False, False, False]


@functools.lru_cache(maxsize=None)
def _jax_step(epoch, fused):
    """(metrics, grads, new params) of one JAX threshold-mode train step."""
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(use_fused_attention=fused, **MODEL),
        pruning=JaxPruningConfig(**TPRUNING), train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params = _student_params()
    tx = jax_make_optimizer(cfg.train, STEPS_PER_EPOCH)
    opt_state = _set_schedule_count(tx.init(params), epoch * STEPS_PER_EPOCH)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = _with_interpret(lambda: step(
        state, _teacher_params(), jnp.asarray(_images()), jnp.asarray(_labels()),
        jax.random.PRNGKey(3), jnp.float32(epoch)))
    updates, _ = tx.update(probed.opt_state, opt_state, params)
    return (metrics, state_dict_from_jax(probed.opt_state),
            state_dict_from_jax(optax.apply_updates(params, updates)))


@pytest.mark.parametrize("jax_fused,port_fused", [(False, False), (True, True)])
def test_threshold_train_step_matches_jax(jax_fused, port_fused):
    """One step past warmup: loss and metrics (the mask loss chained by the
    keep masks, the token KL over the last mask's tokens) within 1e-5,
    every gradient within 1e-4 of its tensor's largest magnitude (the
    predictors' last biases, zero in exact arithmetic, against a floor of
    1e-3 of the model's largest gradient, as in test_torch_train_step.py),
    updated parameters within 1e-2 * lr where the gradient's sign is sure."""
    epoch = 6
    metrics, grads, new_params = _jax_step(epoch, jax_fused)
    student = _port_student(port_fused)
    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=port_fused, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = epoch * STEPS_PER_EPOCH
    got = make_train_step(student, teacher, opt, cfg)(
        torch.from_numpy(_images()), torch.from_numpy(_labels()), epoch)
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    labels = label_params(student)
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        sure = np.abs(grads[name]) > 1e-3 * scale
        np.testing.assert_allclose(p.detach().numpy()[sure], new_params[name][sure], rtol=0,
                                   atol=1e-2 * lrs[labels[name]] + 1e-12, err_msg=name)
