"""Port parity of the gumbel baseline: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The gumbel softmax, the DynamicViT predictor, the student in train mode
(gumbel decisions as a keep policy) and eval mode (top-k gather), its
distillation losses and `make_dynamic_vit_train_step`, on the tiny widths
of `test_torch_train.py`. The two packages draw different noise from their
generators, so both get the same numpy uniforms: the port through
`ops.gumbel.uniform_noise`, the JAX model through a `gumbel_softmax_keep`
that runs the JAX package's own function with `jax.random.uniform` handing
out those uniforms (the patch lives here; the JAX package is unchanged).
fp32 on the CPU; each test states its tolerance.
"""

import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dense2sparse_vit_tpu.models.dynamic_vit_default as jax_dvd
import dense2sparse_vit_tpu.ops.gumbel as jax_gumbel
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.losses.distill import (
    dynamic_vit_distill_loss as jax_distill_loss,
    keep_ratio_loss as jax_keep_ratio_loss,
    predictor_bce_vs_teacher as jax_predictor_bce,
)
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import (
    make_dynamic_vit_train_step as jax_make_dynamic_vit_train_step,
)

import dense2sparse_vit_torch.ops.gumbel as port_gumbel
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.losses import (
    dynamic_vit_distill_loss,
    keep_ratio_loss,
    predictor_bce_vs_teacher,
)
from dense2sparse_vit_torch.models import DynamicViTPredictor, create_model
from dense2sparse_vit_torch.train import label_params, make_dynamic_vit_train_step, make_optimizer
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state, random_like_tree
from test_torch_train import MODEL, _images, _labels, _teacher_params, _with_interpret
from test_torch_train_step import STEPS_PER_EPOCH, TRAIN, _grad_probe, _set_schedule_count

B, N = 2, 16
DPRUNING = dict(pruning_locs=(1, 2, 3), keep_ratios=(0.7, 0.49, 0.343), selection="gumbel")
STUDENT = "default_dynamic_vit_small_patch16_224_student"


def _noise(seed=50):
    """One (B, N, 2) array of uniforms in [1e-20, 1) per pruning stage."""
    rng = np.random.default_rng(seed)
    return [np.maximum(rng.random((B, N, 2)), 1e-20).astype(np.float32) for _ in range(3)]


def _jax_keep_from(noise):
    """A `gumbel_softmax_keep` for the JAX model that runs the JAX package's
    function on `noise` (stage after stage, again from the first stage when
    the model is traced again)."""
    stages = itertools.cycle(noise)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = next(stages)
        assert u.shape == tuple(shape)
        return jnp.asarray(u)

    fake_jax = types.SimpleNamespace(random=types.SimpleNamespace(uniform=uniform),
                                     nn=jax.nn, lax=jax.lax)
    real = jax_gumbel.gumbel_softmax_keep

    def keep(key, logits, prev, tau=1.0):
        saved, jax_gumbel.jax = jax_gumbel.jax, fake_jax
        try:
            return real(key, logits, prev, tau=tau)
        finally:
            jax_gumbel.jax = saved

    return keep


def _port_noise(noise):
    stages = itertools.cycle(noise)
    return lambda shape, generator: torch.from_numpy(next(stages))


# ---- the gumbel softmax ---------------------------------------------------


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("tau", [1.0, 0.5])
def test_gumbel_softmax_matches_jax_on_its_noise(monkeypatch, hard, tau):
    """Values and the logits' VJP within 1e-6 on the noise JAX draws from
    its key; hard samples are one-hot, the first index on ties."""
    rng = np.random.default_rng(51)
    logits = rng.standard_normal((B, 5, 3)).astype(np.float32)
    logits[0, 0] = 0.0  # equal logits: the noise decides
    g = rng.standard_normal(logits.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want, vjp = jax.vjp(lambda a: jax_gumbel.gumbel_softmax(key, a, tau=tau, hard=hard),
                        jnp.asarray(logits))
    (want_g,) = vjp(jnp.asarray(g))
    noise = np.asarray(jax.random.uniform(key, logits.shape, jnp.float32, 1e-20, 1.0))
    monkeypatch.setattr(port_gumbel, "uniform_noise",
                        lambda shape, generator: torch.tensor(noise))
    lt = torch.from_numpy(logits).requires_grad_()
    got = port_gumbel.gumbel_softmax(lt, torch.Generator(), tau=tau, hard=hard)
    (got_g,) = torch.autograd.grad(got, lt, torch.from_numpy(g))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **tol)
    if hard:
        assert set(np.unique(got.detach().numpy().round(6))) <= {0.0, 1.0}


def test_gumbel_softmax_keep_matches_jax(monkeypatch):
    """The cumulative decision within 1e-6 (one fp32 rounding of the
    straight-through sum), and 0 wherever the previous one is."""
    rng = np.random.default_rng(52)
    logits = rng.standard_normal((B, N, 2)).astype(np.float32)
    prev = (rng.random((B, N, 1)) < 0.7).astype(np.float32)
    noise = _noise(53)[:1]
    want = _jax_keep_from(noise)(jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(prev))
    monkeypatch.setattr(port_gumbel, "uniform_noise", _port_noise(noise))
    got = port_gumbel.gumbel_softmax_keep(torch.from_numpy(logits), torch.from_numpy(prev),
                                          torch.Generator())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert (got.numpy()[prev == 0] == 0).all()


def test_uniform_noise_is_in_range_and_follows_the_generator():
    a = port_gumbel.uniform_noise((4, 7), torch.Generator().manual_seed(1))
    b = port_gumbel.uniform_noise((4, 7), torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert (a >= 1e-20).all() and (a < 1).all()


# ---- the predictor and the student ---------------------------------------


def test_dynamic_vit_predictor_matches_jax():
    """(B, N, 2) log-probabilities within 1e-5, a policy with dropped tokens."""
    rng = np.random.default_rng(54)
    x = rng.standard_normal((B, N, 64)).astype(np.float32)
    pol = (rng.random((B, N, 1)) < 0.6).astype(np.float32)
    mod = jax_dvd.DynamicViTPredictor(embed_dim=64)
    params = random_like_tree(
        jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pol))
        ["params"], seed=55)
    want = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(pol))
    sd = state_dict_from_jax({"score_predictor_0": params})
    port = load_numpy_state(DynamicViTPredictor(64),
                            {k[len("score_predictor.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(pol))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _student_params():
    student = jax_dvd.DynamicViTStudent(cfg=JaxModelConfig(**MODEL),
                                        pruning=JaxPruningConfig(**DPRUNING))
    shapes = jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=56)


def _port_student(use_fused):
    model = create_model(STUDENT, device="cpu", use_fused_attention=use_fused, **MODEL,
                         **DPRUNING)
    return load_numpy_state(model, state_dict_from_jax(_student_params()))


def _run_jax(fn, noise):
    real = jax_dvd.gumbel_softmax_keep
    jax_dvd.gumbel_softmax_keep = _jax_keep_from(noise)
    try:
        return _with_interpret(fn)
    finally:
        jax_dvd.gumbel_softmax_keep = real


@functools.lru_cache(maxsize=None)
def _jax_forward(training, fused):
    student = jax_dvd.DynamicViTStudent(
        cfg=JaxModelConfig(use_fused_attention=fused, **MODEL),
        pruning=JaxPruningConfig(**DPRUNING))
    run = jax.jit(lambda p, x: student.apply({"params": p}, x, training=training,
                                             rngs={"gumbel": jax.random.PRNGKey(1)}))
    return _run_jax(lambda: run(_student_params(), jnp.asarray(_images())), _noise())


def test_state_dict_keys_are_the_jax_params():
    port = create_model(STUDENT, device="cpu", **MODEL, **DPRUNING)
    sd = state_dict_from_jax(_student_params())
    assert set(sd) == set(port.state_dict())
    assert "score_predictor.2.out_conv.4.weight" in sd


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("jax_fused,port_fused", [(False, False), (True, True)])
def test_dynamic_vit_student_matches_jax(monkeypatch, training, jax_fused, port_fused):
    """Train mode (gumbel policy, all N tokens throughout): logits,
    features and keep probabilities within 1e-4, the hard decisions the
    same (their values are y_hard + y_soft - y_soft, 0 or 1 up to one fp32
    rounding, which XLA and torch may place differently: within 1e-6).
    Eval mode (top-k gather): the same, and the kept indices exact."""
    want = _jax_forward(training, jax_fused)
    monkeypatch.setattr(port_gumbel, "uniform_noise", _port_noise(_noise()))
    model = _port_student(port_fused).train(training)
    with torch.no_grad():
        got = model(torch.from_numpy(_images()), generator=torch.Generator())
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **tol)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **tol)
    for g, w in zip(got.pred_keep_probs, want.pred_keep_probs, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    if training:
        assert got.features.shape == (B, N, 64) and got.kept_idx_orig is None
        np.testing.assert_array_equal(got.decisions.numpy().round(),
                                      np.asarray(want.decisions).round())
        np.testing.assert_allclose(got.decisions.numpy(), np.asarray(want.decisions),
                                   rtol=0, atol=1e-6)
        assert 0 < got.decisions.sum() < B * N  # some tokens dropped, some kept
    else:
        assert got.decisions is None
        np.testing.assert_array_equal(got.kept_idx_orig.numpy(), np.asarray(want.kept_idx_orig))


def test_train_mode_needs_a_generator():
    model = _port_student(False).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(_images()))


# ---- the distillation losses ----------------------------------------------


@pytest.mark.parametrize("mixup", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_distill_losses_match_jax(mixup, temperature):
    """dynamic_vit_distill_loss (every term on), keep_ratio_loss and
    predictor_bce_vs_teacher: values, metrics and the student inputs'
    gradients within 1e-5."""
    rng = np.random.default_rng(57)
    c, d = 10, 8
    ls, lt = (rng.standard_normal((B, c)).astype(np.float32) for _ in range(2))
    ts, tt = (rng.standard_normal((B, N, d)).astype(np.float32) for _ in range(2))
    probs = [rng.random((B, N)).astype(np.float32) for _ in range(3)]
    dec = (rng.random((B, N, 1)) < 0.5).astype(np.float32)
    target = rng.random((B, N)).astype(np.float32)
    labels = rng.dirichlet(np.ones(c), B).astype(np.float32) if mixup else _labels()
    ratios = DPRUNING["keep_ratios"]

    def jax_fn(a, b, p):
        loss, m = jax_distill_loss(a, b, jnp.asarray(lt), jnp.asarray(tt), jnp.asarray(labels),
                                   p, jnp.asarray(dec), ratios, cls_weight=0.7,
                                   mixup_active=mixup, temperature=temperature)
        bce = jax_predictor_bce(p, jnp.asarray(target), ratios)
        return loss + bce, (m, bce, jax_keep_ratio_loss(p, ratios))

    (want, (want_m, want_bce, want_r)), want_g = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(ls), jnp.asarray(ts), [jnp.asarray(p) for p in probs])
    a, b = torch.from_numpy(ls).requires_grad_(), torch.from_numpy(ts).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in probs]
    loss, m = dynamic_vit_distill_loss(a, b, torch.from_numpy(lt), torch.from_numpy(tt),
                                       torch.from_numpy(labels), pt, torch.from_numpy(dec),
                                       ratios, cls_weight=0.7, mixup_active=mixup,
                                       temperature=temperature)
    bce = predictor_bce_vs_teacher(pt, torch.from_numpy(target), ratios)
    got_g = torch.autograd.grad(loss + bce, [a, b, *pt])
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((loss + bce).item(), float(want), **tol)
    np.testing.assert_allclose(bce.item(), float(want_bce), **tol)
    np.testing.assert_allclose(keep_ratio_loss(pt, ratios).item(), float(want_r), **tol)
    assert set(m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(m[k].item(), float(want_m[k]), err_msg=k, **tol)
    for g, w in zip(got_g, [want_g[0], want_g[1], *want_g[2]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---- the train step -------------------------------------------------------

LOSSES = {
    # every term of the recipe, the predictors' BCE against the teacher too
    "full": dict(use_ratio_loss=True, use_token_dist_loss=True, teacher_cls_loss=True,
                 softmax_temp=2.0),
    # no term reads the keep probabilities: the predictors learn only through
    # the straight-through decisions and dPolicy
    "policy_only": dict(use_token_dist_loss=True),
}


@functools.lru_cache(maxsize=None)
def _jax_step(losses, fused, epoch=6, warmup_freeze=True):
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(use_fused_attention=fused, **MODEL),
        pruning=JaxPruningConfig(**DPRUNING), train=JaxTrainConfig(**TRAIN, **LOSSES[losses]))
    student = jax_dvd.DynamicViTStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params = _student_params()
    tx = jax_make_optimizer(cfg.train, STEPS_PER_EPOCH, backbone_warmup_freeze=warmup_freeze)
    opt_state = _set_schedule_count(tx.init(params), epoch * STEPS_PER_EPOCH)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_dynamic_vit_train_step(student, teacher, probe, cfg))
    probed, metrics = _run_jax(lambda: step(
        state, _teacher_params(), jnp.asarray(_images()), jnp.asarray(_labels()),
        jax.random.PRNGKey(3), jnp.float32(epoch)), _noise())
    updates, _ = tx.update(probed.opt_state, opt_state, params)
    return (metrics, state_dict_from_jax(probed.opt_state),
            state_dict_from_jax(optax.apply_updates(params, updates)))


@pytest.mark.parametrize("losses,jax_fused,port_fused", [
    ("full", False, False), ("full", True, True), ("policy_only", True, True)])
def test_dynamic_vit_train_step_matches_jax(monkeypatch, losses, jax_fused, port_fused):
    """One step past warmup: loss and metrics within 1e-5; every gradient,
    the predictors' (through dPolicy and the straight-through decisions)
    included, within 1e-4 of its tensor's largest magnitude (against a
    floor of 1e-3 of the model's largest gradient, as in
    test_torch_train_step.py); updated parameters within 1e-2 * lr where
    the gradient's sign is sure."""
    metrics, grads, new_params = _jax_step(losses, jax_fused)
    monkeypatch.setattr(port_gumbel, "uniform_noise", _port_noise(_noise()))
    student = _port_student(port_fused)
    teacher = create_model("default_dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=port_fused, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN, **LOSSES[losses]))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = 6 * STEPS_PER_EPOCH
    ops.reset_launch_counts()
    step = make_dynamic_vit_train_step(student, teacher, opt, cfg, generator=torch.Generator())
    got = step(torch.from_numpy(_images()), torch.from_numpy(_labels()), 6)
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
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        sure = np.abs(grads[name]) > 1e-3 * scale
        np.testing.assert_allclose(p.detach().numpy()[sure], new_params[name][sure], rtol=0,
                                   atol=1e-2 * lrs[labels[name]] + 1e-12, err_msg=name)
    # the predictors learn, in "policy_only" through dPolicy alone
    assert all(np.abs(grads[f"score_predictor.{p}.in_conv.1.weight"]).max() > floor
               for p in range(3))


@pytest.mark.parametrize("warmup_freeze", [False, True])
def test_dynamic_vit_train_step_in_warmup_matches_jax(monkeypatch, warmup_freeze):
    """One step at epoch 0, inside the warmup: with the backbone's warmup
    freeze off (the gumbel baseline's recipe, JAX train/loop.py) the
    backbone trains at its capped lr and every updated parameter is within
    1e-2 * lr of JAX's where the gradient's sign is sure, as in the test
    above; with it on (the default) the backbone's lr is 0 and it stays
    put, as in JAX."""
    _, grads, new_params = _jax_step("full", True, 0, warmup_freeze)
    monkeypatch.setattr(port_gumbel, "uniform_noise", _port_noise(_noise()))
    student = _port_student(True)
    teacher = create_model("default_dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=True, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN, **LOSSES["full"]))
    kw = {} if warmup_freeze else {"backbone_warmup_freeze": False}
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH, **kw)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    step = make_dynamic_vit_train_step(student, teacher, opt, cfg, generator=torch.Generator())
    step(torch.from_numpy(_images()), torch.from_numpy(_labels()), 0)
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    labels = label_params(student)
    assert (lrs["base_decay"] > 0) != warmup_freeze and lrs["predictor"] > 0
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        sure = np.abs(grads[name]) > 1e-3 * scale
        np.testing.assert_allclose(p.detach().numpy()[sure], new_params[name][sure], rtol=0,
                                   atol=1e-2 * lrs[labels[name]] + 1e-12, err_msg=name)
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (labels[name] == "predictor" or not warmup_freeze), name
