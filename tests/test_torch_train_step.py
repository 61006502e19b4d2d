"""Port parity of the training step: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

Parameter groups, the lr schedule, one AdamW update, and the whole train
step (teacher, student, both losses, backward, update) against the JAX
package's `make_train_step` on a tiny student and teacher with the same
weights and batch. fp32 on the CPU; each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.optimizer import label_params as jax_label_params
from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from dense2sparse_vit_tpu.train.schedule import backbone_lr as jax_backbone_lr
from dense2sparse_vit_tpu.train.schedule import predictor_lr as jax_predictor_lr
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, ModelConfig, PruningConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.train.schedule import backbone_lr
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state
from test_torch_train import (
    MODEL, PRUNING, _images, _labels, _student_params, _teacher_params, _with_interpret)

TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH = 3


def _port_student(use_fused=False):
    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu",
                         use_fused_attention=use_fused, **MODEL, **PRUNING)
    return load_numpy_state(model, state_dict_from_jax(_student_params()))


def test_param_groups_match_jax_label_params():
    want = {k: str(v) for k, v in state_dict_from_jax(jax_label_params(_student_params())).items()}
    got = label_params(_port_student())
    assert got == want
    assert set(got.values()) == {"frozen", "predictor", "base_decay", "base_no_decay"}


@pytest.mark.parametrize("freeze_backbone", [False, True])
def test_group_lrs_follow_the_schedule(freeze_backbone):
    cfg = TrainConfig(freeze_backbone=freeze_backbone, **TRAIN)
    jcfg = JaxTrainConfig(freeze_backbone=freeze_backbone, **TRAIN)
    opt = make_optimizer(_port_student(), cfg, STEPS_PER_EPOCH)
    seen = []
    for count in range(8 * STEPS_PER_EPOCH):
        opt.count = count
        epoch = count // STEPS_PER_EPOCH
        for group in opt.param_groups:
            want = (jax_predictor_lr(epoch, jcfg) if group["label"] == "predictor"
                    else jax_backbone_lr(epoch, jcfg))
            np.testing.assert_allclose(opt.group_lr(group["label"], epoch), float(want),
                                       rtol=1e-6, atol=1e-12)
            seen.append((group["label"], epoch, opt.group_lr(group["label"], epoch)))
    backbone = {e: lr for lbl, e, lr in seen if lbl == "base_decay"}
    assert backbone[4] == 0.0 and (backbone[5] > 0.0) != freeze_backbone


@pytest.mark.parametrize("warmup_freeze", [True, False])
@pytest.mark.parametrize("epoch", [0, 2, 4, 5, 7])
def test_backbone_lr_warmup_switch_matches_jax(epoch, warmup_freeze):
    """backbone_lr with and without the warmup's zero, inside the warmup
    (epochs 0-4) and after it, against JAX's; the optimizer's switch gives
    the same lr to both backbone groups and leaves the predictor's alone."""
    cfg, jcfg = TrainConfig(**TRAIN), JaxTrainConfig(**TRAIN)
    want = float(jax_backbone_lr(epoch, jcfg, warmup_freeze=warmup_freeze))
    np.testing.assert_allclose(backbone_lr(epoch, cfg, warmup_freeze=warmup_freeze), want,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(backbone_lr(torch.tensor(float(epoch)), cfg,
                                                 warmup_freeze=warmup_freeze)), want,
                               rtol=1e-6, atol=1e-12)
    assert (want == 0.0) == (warmup_freeze and epoch < TRAIN["warmup_epochs"])
    opt = make_optimizer(_port_student(), cfg, STEPS_PER_EPOCH,
                         backbone_warmup_freeze=warmup_freeze)
    for group in opt.param_groups:
        lr = opt.group_lr(group["label"], epoch)
        np.testing.assert_allclose(lr, float(jax_predictor_lr(epoch, jcfg))
                                   if group["label"] == "predictor" else want,
                                   rtol=1e-6, atol=1e-12)
    if warmup_freeze:  # the default is the switch on
        default = make_optimizer(_port_student(), cfg, STEPS_PER_EPOCH)
        assert all(default.group_lr(g["label"], epoch) == opt.group_lr(g["label"], epoch)
                   for g in opt.param_groups)
        assert backbone_lr(epoch, cfg) == backbone_lr(epoch, cfg, warmup_freeze=True)


def test_adamw_update_matches_optax():
    """One update at a past-warmup count on fixed gradients: every group,
    within 1e-7 plus one fp32 rounding of the parameter (torch decays the
    weight and adds the Adam step in two roundings, optax adds their sum in
    one); cls_token and pos_embed stay put."""
    params = _student_params()
    rng = np.random.default_rng(28)
    grads = jax.tree_util.tree_map(
        lambda v: rng.standard_normal(np.shape(v)).astype(np.float32), params)
    count = 6 * STEPS_PER_EPOCH
    tx = jax_make_optimizer(JaxTrainConfig(**TRAIN), STEPS_PER_EPOCH)
    state = _set_schedule_count(tx.init(params), count)
    updates, _ = tx.update(grads, state, params)
    want = state_dict_from_jax(optax.apply_updates(params, updates))

    model = _port_student()
    opt = make_optimizer(model, TrainConfig(**TRAIN), STEPS_PER_EPOCH)
    opt.count = count
    for name, g in state_dict_from_jax(grads).items():
        dict(model.named_parameters())[name].grad = torch.from_numpy(g)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=2.0 ** -23,
                                   atol=1e-7, err_msg=name)
    assert torch.equal(model.cls_token, before["cls_token"])
    assert torch.equal(model.pos_embed, before["pos_embed"])
    assert not torch.equal(model.head.weight, before["head.weight"])


def _set_schedule_count(opt_state, count):
    """optax state with every schedule's update count set to `count` (Adam's
    own counts stay at 0, as a fresh torch AdamW's do)."""
    return jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(count, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s,
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))


# ---- the train step, the slice as a whole --------------------------------


def _grad_probe():
    """An optax transformation that applies no update and keeps the
    gradients as its state."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


@functools.lru_cache(maxsize=None)
def _jax_step(epoch, fused):
    """(metrics, grads, new params, kept_idx) of one JAX train step at `epoch`
    with the schedule count at epoch * STEPS_PER_EPOCH."""
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(use_fused_attention=fused, **MODEL),
        pruning=JaxPruningConfig(**PRUNING), train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    imgs, labels = jnp.asarray(_images()), jnp.asarray(_labels())
    params = _student_params()

    tx = jax_make_optimizer(cfg.train, STEPS_PER_EPOCH)
    opt_state = _set_schedule_count(tx.init(params), epoch * STEPS_PER_EPOCH)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = _with_interpret(lambda: step(
        state, _teacher_params(), imgs, labels, jax.random.PRNGKey(3), jnp.float32(epoch)))
    # the update the JAX step makes with its optimizer, from those gradients
    updates, _ = tx.update(probed.opt_state, opt_state, params)
    out = _with_interpret(lambda: jax.jit(lambda p, x: student.apply(
        {"params": p}, x, deterministic=False, collect_cls_attns=False))(params, imgs))
    return (metrics, state_dict_from_jax(probed.opt_state),
            state_dict_from_jax(optax.apply_updates(params, updates)),
            [np.asarray(k) for k in out.kept_idx])


@pytest.mark.parametrize("epoch,jax_fused,port_fused", [
    (6, False, False), (2, False, False), (6, False, True), (6, True, True),
])
def test_train_step_matches_jax(epoch, jax_fused, port_fused):
    """Past warmup (epoch 6) and in warmup (epoch 2, the backbone frozen):
    loss and metrics within 1e-5, kept_idx exact, every gradient within 1e-4
    of its tensor's largest magnitude, updated parameters within 1e-2 * lr.
    The predictors' last LayerNorm bias and last Linear bias shift all of a
    sample's scores alike, which the softmax ignores: their gradients are
    zero in exact arithmetic, rounding noise of ~1e-8 here, and are held to
    1e-4 of a floor of 1e-3 of the largest gradient of the model instead.

    A first Adam step moves a parameter by lr * g / (|g| + eps), about
    lr * sign(g): where |g| is below the gradients' tolerance its sign is
    rounding noise (the key bias's gradient, for one, is zero in exact
    arithmetic: softmax ignores a shift of a row's scores), so there the
    update is only held to its size, at most lr (1 + weight_decay |p|)."""
    metrics, grads, new_params, kept = _jax_step(epoch, jax_fused)
    student = _port_student(port_fused)
    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=port_fused, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = epoch * STEPS_PER_EPOCH
    x = torch.from_numpy(_images())
    with torch.no_grad():
        got_kept = student.train()(x).kept_idx
    for g, w in zip(got_kept, kept):
        np.testing.assert_array_equal(g.numpy(), w)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    ops.reset_launch_counts()
    got = make_train_step(student, teacher, opt, cfg)(x, torch.from_numpy(_labels()), epoch)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU tensors
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    labels = label_params(student)
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(p, before[name]), name
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        lr = lrs[labels[name]]
        sure = np.abs(grads[name]) > 1e-3 * scale
        new = p.detach().numpy()
        np.testing.assert_allclose(new[sure], new_params[name][sure], rtol=0,
                                   atol=1e-2 * lr + 1e-12, err_msg=name)
        step_bound = 1.01 * lr * (1 + cfg.train.weight_decay * np.abs(before[name].numpy()))
        assert (np.abs(new - before[name].numpy()) <= step_bound + 1e-7).all(), name
        if labels[name] != "predictor" and epoch < TRAIN["warmup_epochs"]:
            assert torch.equal(p, before[name]), name


def test_unported_training_options_are_rejected():
    student = _port_student()
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(grad_accum_steps=2))
    with pytest.raises(NotImplementedError, match="grad_accum_steps"):
        make_train_step(student, student, make_optimizer(student, cfg.train, 1), cfg)
    with pytest.raises(NotImplementedError, match="mixup"):
        make_train_step(student, student, None, cfg.replace(train=TrainConfig()),
                        mixup_active=True)


def test_mean_heads_is_a_pruning_field_again():
    assert PruningConfig().mean_heads is False
    assert JaxPruningConfig().mean_heads is False
    assert ModelConfig().use_fused_attention is False


def test_create_model_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would build there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("dynamic_vit_tiny_patch16_224_student")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("dynamic_vit_tiny_patch16_224_teacher")
    model = create_model("dynamic_vit_tiny_patch16_224_student", device="cpu", **MODEL,
                         **PRUNING)
    assert next(model.parameters()).device.type == "cpu"
