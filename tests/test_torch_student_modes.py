"""Port parity of the student's other pruning and training modes:
dense2sparse_vit_torch vs dense2sparse_vit_tpu.

Perturbed (soft) top-k and its sigma schedule, random and teacher-CLS
selection, the BatchNorm predictor, the early-exit head, elementwise
dropout, attn selection with a stage at block 0, and remat: the operation,
the predictor, the student's forward in train and eval mode, two train
steps (loss, metrics, Adam moments, parameters, BatchNorm statistics) and
the eval step, each against the JAX package's on the same weights and
batch; the converter both ways; remat's gradients against the plain
step's. The two packages draw different random numbers, so both get the
same numpy draws, by shape and in call order: the port through
`models.student.random_scores`, `ops.perturbed_topk.gaussian_noise` and
`nn.layers.dropout_keep_mask`; the JAX model through a `jax.random`
stand-in in its student and perturbed top-k modules and a flax interceptor
on `nn.Dropout` (the patches live here; the JAX package is unchanged).
fp32 on the CPU at depth 3 (stages at blocks 1 and 2, or 0 and 2), C=128,
N=16; each test states its tolerance.
"""

import contextlib
import functools
import importlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dense2sparse_vit_tpu.models.student as jax_student_module
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.registry import create_model as jax_create_model
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.nn.predictor import PredictorLG as JaxPredictorLG
from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from dense2sparse_vit_tpu.train.schedule import sigma_schedule as jax_sigma_schedule
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_eval_step as jax_make_eval_step
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step
from dense2sparse_vit_tpu.utils.convert import (
    convert_student_state_dict,
    export_student_state_dict,
)

import dense2sparse_vit_torch.models.student as port_student_module
import dense2sparse_vit_torch.nn.layers as port_layers
import dense2sparse_vit_torch.ops.perturbed_topk as port_ptk
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.nn import PredictorLG
from dense2sparse_vit_torch.ops.perturbed_topk import PerturbedTopK, perturbed_topk
from dense2sparse_vit_torch.train import (
    label_params,
    make_dynamic_vit_train_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
    sigma_schedule,
)
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state, random_like_tree
from test_torch_train_step import _set_schedule_count
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the JAX package's ops/__init__ binds `perturbed_topk` to the function
jax_ptk = importlib.import_module("dense2sparse_vit_tpu.ops.perturbed_topk")

MODEL = dict(img_size=32, patch_size=8, embed_dim=128, depth=3, num_heads=2, num_classes=10)
PRUNING = dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True)
B, N, NS = 4, 16, 24
TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH = 3
EPOCH = 6  # past the warmup: the backbone trains too
STUDENT = "dynamic_vit_small_patch16_224_student"
TEACHER = "dynamic_vit_small_patch16_224_teacher"
# mode -> (ModelConfig fields, PruningConfig fields). The modes are
# combined, several to a student, to keep the JAX compiles few; every mode
# the port adds runs in one of them. The early-exit head trains under mixup
# in the random student and without it in the teacher-CLS one. Under the
# BatchNorm predictor both packages ignore remat (its running statistics
# would move twice); remat's own test holds its gradients to the plain
# step's (test_remat_gradients_equal_the_plain_steps).
MODES = {
    "random_dropout_early_exit": (dict(drop_rate=0.1, attn_drop_rate=0.1),
                                  dict(selection="random", early_exit=True)),
    "cls_from_teacher_early_exit": ({}, dict(cls_from_teacher=True, early_exit=True)),
    "bn_soft_topk_remat": (dict(remat=True), dict(predictor_bn=True, differentiable_topk=True,
                                                  topk_num_samples=NS)),
    "attn_block0_dropout": (dict(drop_rate=0.1), dict(selection="attn", pruning_locs=(0, 2))),
    "bn_large_early_exit": ({}, dict(predictor_bn=True, early_exit=True, small_predictor=False)),
}
FORWARD_MODES = [m for m in MODES if m != "bn_large_early_exit"]
MIXUP_MODE = "random_dropout_early_exit"


def _compiled(fn, *args):
    """fn jitted and compiled for `args` at XLA's backend optimization level
    0, which halves the compile time of these small graphs."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _fields(mode):
    model, pruning = MODES[mode]
    return {**MODEL, **model}, {**PRUNING, **pruning}


def _jax_cfg(mode):
    model, pruning = _fields(mode)
    return JaxExperimentConfig(model=JaxModelConfig(**model), pruning=JaxPruningConfig(**pruning),
                               train=JaxTrainConfig(**TRAIN))


def _images(seed=70):
    return np.random.default_rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)


LABELS = np.array([3, 7, 1, 0])


def _random_stats(tree, seed):
    """Running statistics drawn from numpy: means near 0, variances in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        v = 0.1 * rng.standard_normal(shape) if name == "mean" else rng.uniform(0.5, 1.5, shape)
        return v.astype(np.float32)

    return walk(tree, None)


@functools.lru_cache(maxsize=None)
def _jax_variables(mode):
    cfg = _jax_cfg(mode)
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    shapes = jax.eval_shape(lambda: student.init(
        {"params": jax.random.PRNGKey(0), "selection": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3)), deterministic=True))
    out = {"params": random_like_tree(shapes["params"], seed=21)}
    if "batch_stats" in shapes:
        out["batch_stats"] = _random_stats(shapes["batch_stats"], seed=23)
    return out


@functools.lru_cache(maxsize=None)
def _teacher_params():
    teacher = JaxTeacher(cfg=JaxModelConfig(**MODEL))
    shapes = jax.eval_shape(teacher.init, jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    return random_like_tree(shapes["params"], seed=22)


def _teacher_attns(seed=71):
    """A (B, L, H, N+1) stack of CLS-attention rows: positive, rows sum to 1."""
    a = np.random.default_rng(seed).random((B, MODEL["depth"], MODEL["num_heads"], N + 1)) + 0.05
    return (a / a.sum(-1, keepdims=True)).astype(np.float32)


def _port(mode, fused=False):
    model, pruning = _fields(mode)
    student = create_model(STUDENT, device="cpu", use_fused_attention=fused, **model, **pruning)
    load_numpy_state(student, state_dict_from_jax(_jax_variables(mode)))
    teacher = create_model(TEACHER, device="cpu", use_fused_attention=fused, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))
    return student, teacher


# ---- the same draws on both sides --------------------------------------------


@contextlib.contextmanager
def same_draws(seed=80):
    """Within the context both packages draw their random scores, soft top-k
    noise and dropout masks from numpy streams seeded alike: the i-th draw
    of a kind and shape is the same array on both sides. A JAX function
    draws when it is traced: a jitted step is traced anew for each step."""
    streams = {side: {kind: np.random.default_rng([seed, i]) for i, kind in
                      enumerate(("uniform", "normal", "mask"))} for side in ("port", "jax")}
    port, jx = streams["port"], streams["jax"]

    drawn = {}

    def port_draw(kind, shape, generator, make):
        """The next array of the port's stream, or, where the generator is
        back at a state it drew from before (remat's recompute restores
        it), the array drawn then. The generator advances as a draw would
        advance it."""
        key = (kind, tuple(shape), generator.get_state().numpy().tobytes())
        if key not in drawn:
            drawn[key] = make(port[kind], tuple(shape))
        torch.rand(1, generator=generator)
        return torch.from_numpy(drawn[key])

    def port_uniform(shape, generator):
        return port_draw("uniform", shape, generator,
                         lambda r, sh: r.random(sh).astype(np.float32))

    def port_normal(shape, generator):
        return port_draw("normal", shape, generator,
                         lambda r, sh: r.standard_normal(sh).astype(np.float32))

    def port_mask(shape, keep, generator):
        return port_draw("mask", shape, generator, lambda r, sh: r.random(sh) < keep)

    def jax_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(jx["uniform"].random(tuple(shape)).astype(np.float32))

    def jax_normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(jx["normal"].standard_normal(tuple(shape)).astype(np.float32))

    def dropout(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic")
        det = mod.deterministic if det is None else det
        if mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        x, keep = args[0], 1.0 - mod.rate
        mask = jx["mask"].random(x.shape) < keep
        return jnp.where(mask, x / keep, jnp.zeros((), x.dtype))

    saved = (port_student_module.random_scores, port_ptk.gaussian_noise,
             port_layers.dropout_keep_mask, jax_student_module.jax, jax_ptk.jax)
    port_student_module.random_scores = port_uniform
    port_ptk.gaussian_noise = port_normal
    port_layers.dropout_keep_mask = port_mask
    jax_student_module.jax = types.SimpleNamespace(
        random=types.SimpleNamespace(uniform=jax_uniform), lax=jax.lax, nn=jax.nn)
    jax_ptk.jax = types.SimpleNamespace(random=types.SimpleNamespace(normal=jax_normal),
                                        lax=jax.lax)
    try:
        with fnn.intercept_methods(dropout):
            yield
    finally:
        (port_student_module.random_scores, port_ptk.gaussian_noise,
         port_layers.dropout_keep_mask, jax_student_module.jax, jax_ptk.jax) = saved


# ---- perturbed top-k -----------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_perturbed_topk_and_its_vjp_match_jax(ties):
    """The indicator within 1e-6 (JAX adds 1/nS once per sample, the port
    counts and scales once), its VJP within 1e-5 of its largest magnitude.
    With ties: scores on a 4-value grid and sigma at its 1e-12 floor, where
    the noise vanishes below one rounding and equal scores rank by lowest
    index first on both sides."""
    rng = np.random.default_rng(60)
    n, k = 20, 7
    if ties:
        x, sigma = rng.integers(0, 4, (B, n)).astype(np.float32) / 4, 1e-12
    else:
        x, sigma = rng.standard_normal((B, n)).astype(np.float32), 0.3
    z = rng.standard_normal((B, NS, n)).astype(np.float32)
    g = rng.standard_normal((B, k, n)).astype(np.float32)
    sig = jnp.float32(sigma)
    want, vjp = jax.vjp(lambda v: jax_ptk._perturbed_topk_core(v, jnp.asarray(z), sig,
                                                               jnp.zeros((k,), jnp.int8)),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = PerturbedTopK.apply(xt, torch.from_numpy(z), torch.tensor(sigma), k)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy().sum(-1), 1.0, rtol=0, atol=1e-5)
    want_dx = np.asarray(want_dx)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-5 * np.abs(want_dx).max())


@pytest.mark.parametrize("sigma", [0.05, 0.0])
def test_perturbed_topk_wrapper_matches_jax(sigma):
    """The wrappers on the same Gaussian draws: sigma 0 (the schedule's last
    epoch) is clamped at 1e-12 on both sides; indicator within 1e-6,
    gradient within 1e-5 of its largest magnitude."""
    x = np.random.default_rng(61).random((B, N)).astype(np.float32)
    k = 9
    with same_draws():
        want, vjp = jax.vjp(lambda v: jax_ptk.perturbed_topk(jax.random.PRNGKey(0), v, k,
                                                              num_samples=NS, sigma=sigma),
                            jnp.asarray(x))
        (want_dx,) = vjp(jnp.ones((B, k, N)) * jnp.arange(N, dtype=jnp.float32))
        xt = torch.from_numpy(x).requires_grad_()
        got = perturbed_topk(xt, k, torch.Generator(), num_samples=NS, sigma=sigma)
        (got * torch.arange(N, dtype=torch.float32)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    want_dx = np.asarray(want_dx)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-5 * max(np.abs(want_dx).max(), 1e-30))


def test_perturbed_topk_keeps_no_one_hot_for_its_backward():
    """What the function saves for its backward, recorded by
    saved_tensors_hooks: nothing of B nS k N elements (the one-hot the
    reference builds), nothing larger than the (B, nS, N) noise, and the
    indices in int16."""
    k, ns = 11, 40
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = torch.rand((B, N), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        perturbed_topk(x, k, torch.Generator().manual_seed(0), num_samples=ns).sum().backward()
    sizes = [int(np.prod(s)) for s, _ in saved]
    assert saved and B * ns * k * N not in sizes and max(sizes) <= B * ns * N, saved
    assert ((B, ns, k), torch.int16) in saved


@pytest.mark.parametrize("epoch", [0, 3, 9.5, 10, 12])
def test_sigma_schedule_matches_jax(epoch):
    want = float(jax_sigma_schedule(epoch, 10, 0.05))
    np.testing.assert_allclose(sigma_schedule(epoch, 10, 0.05), want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(sigma_schedule(torch.tensor(float(epoch)), 10, 0.05)), want,
                               rtol=1e-6, atol=1e-12)


# ---- the BatchNorm predictor -----------------------------------------------------


def test_bn_layer_is_torch_batchnorm1d():
    """BatchNormLayer on (B, N, C) is nn.BatchNorm1d on its (B N, C) rows:
    outputs and running statistics bit-equal, in train and eval mode."""
    rng = np.random.default_rng(63)
    layer = port_layers_bn = PredictorLG(32, True, use_bn=True).in_conv[0]
    ref = torch.nn.BatchNorm1d(32)
    with torch.no_grad():
        for p in (layer.bn.weight, layer.bn.bias):
            p.copy_(torch.from_numpy(rng.standard_normal(32).astype(np.float32)))
    ref.load_state_dict(layer.bn.state_dict())
    for training in (True, True, False):
        x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32) + 2.0)
        with torch.no_grad():
            got = port_layers_bn.train(training)(x)
            want = ref.train(training)(x.reshape(-1, 32)).view(x.shape)
        assert torch.equal(got, want)
        for k, v in ref.state_dict().items():
            assert torch.equal(layer.bn.state_dict()[k], v), k


def test_bn_predictor_matches_jax():
    """Two train-mode calls (batch statistics, the running ones updated with
    the unbiased variance) then an eval-mode call (the running ones), at
    B=8: scores and keep probabilities within 1e-4 of their largest
    magnitude, the running statistics within 1e-5. Not tighter: the JAX
    layer takes the batch variance as E[x^2] - mean^2 in fp32, which loses
    digits where a channel's spread is small beside its mean (the pooled
    global half, which varies only between samples), and the port takes
    torch's BatchNorm1d (`test_bn_layer_is_torch_batchnorm1d`); at B=2 the
    JAX layer is off by ~1e-3 there."""
    C = 64
    small = False  # the large predictor; the students' tests run the small one
    pred = JaxPredictorLG(embed_dim=C, small_predictor=small, use_bn=True)
    rng = np.random.default_rng(62)
    xs = [rng.standard_normal((8, N, C)).astype(np.float32) for _ in range(3)]
    shapes = jax.eval_shape(pred.init, jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    variables = {"params": random_like_tree(shapes["params"], seed=24),
                 "batch_stats": _random_stats(shapes["batch_stats"], seed=25)}
    sd = state_dict_from_jax({"params": {"score_predictor_0": variables["params"]},
                              "batch_stats": {"score_predictor_0": variables["batch_stats"]}})
    port = PredictorLG(C, small, use_bn=True)
    load_numpy_state(port, {k[len("score_predictor.0."):]: v for k, v in sd.items()})
    assert port.act == "relu"
    train = jax.jit(lambda v, x: pred.apply(v, x, use_running_average=False,
                                            mutable=["batch_stats"]))
    evaluate = jax.jit(lambda v, x: pred.apply(v, x, use_running_average=True))
    for i, x in enumerate(xs):
        training = i < 2
        if training:
            (want, want_p), mutated = train(variables, jnp.asarray(x))
            variables = {**variables, "batch_stats": mutated["batch_stats"]}
        else:
            want, want_p = evaluate(variables, jnp.asarray(x))
        with torch.no_grad():
            got, got_p = port.train(training)(torch.from_numpy(x))
        want, want_p = np.asarray(want), np.asarray(want_p)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0,
                                   atol=1e-4 * np.abs(want_p).max())
        stats = state_dict_from_jax({"params": {"score_predictor_0": variables["params"]},
                                     "batch_stats": {"score_predictor_0":
                                                     variables["batch_stats"]}})
        for k, v in port.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), stats[f"score_predictor.0.{k}"],
                                           rtol=1e-5, atol=1e-5, err_msg=k)
            if "num_batches_tracked" in k:
                assert int(v) == min(i + 1, 2)


# ---- the student's forward -------------------------------------------------------


def _jax_forward(mode, training, teacher_attns, images):
    cfg = _jax_cfg(mode)
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    variables = _jax_variables(mode)
    kw = dict(deterministic=not training, collect_cls_attns=False,
              rngs={"selection": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)})
    if cfg.pruning.cls_from_teacher:
        kw["teacher_cls_attns"] = jnp.asarray(teacher_attns)
    if cfg.pruning.differentiable_topk:
        kw.update(soft_topk=True, sigma=0.02)
    mutable = ["batch_stats"] if training and "batch_stats" in variables else False
    args = (variables, jnp.asarray(images))
    out = _compiled(lambda v, x: student.apply(v, x, mutable=mutable, **kw), *args)(*args)
    return out[0] if mutable else out


@pytest.mark.parametrize("mode", FORWARD_MODES)
def test_student_forward_matches_jax(mode):
    """The train-mode forward (batch statistics, dropout, the draws, soft
    top-k): logits, features, early-exit logits and every stage's scores
    within 1e-4 (relative, and of the tensor's largest magnitude); the kept
    indices (in stage and original coordinates) the same. At B=4: the JAX
    BatchNorm's one-pass batch variance (`test_bn_predictor_matches_jax`)
    is off by ~1e-3 at B=2. The eval-mode forwards are held by
    `test_eval_step_matches_jax` (the CE of their logits, the mask loss of
    their scores, the accuracies of their kept tokens)."""
    training = True
    student, _ = _port(mode)
    attns, x = _teacher_attns(), _images()
    with same_draws():
        want = _jax_forward(mode, training, attns, x)
        kw = dict(collect_cls_attns=False, generator=torch.Generator())
        if student.pruning.cls_from_teacher:
            kw["teacher_cls_attns"] = torch.from_numpy(attns)
        if student.pruning.differentiable_topk:
            kw.update(soft_topk=True, sigma=0.02)
        with torch.no_grad():
            got = student.train(training)(torch.from_numpy(x), **kw)
    def close(g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())

    close(got.logits, want.logits)
    close(got.features, want.features)
    assert (got.early_exit_logits is None) == (want.early_exit_logits is None)
    if want.early_exit_logits is not None:
        close(got.early_exit_logits, want.early_exit_logits)
    for g, w in zip(got.pred_logits, want.pred_logits, strict=True):
        close(g, w)
    for g, w in zip(got.kept_idx, want.kept_idx, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.kept_idx_orig.numpy(), np.asarray(want.kept_idx_orig))


# ---- the train step --------------------------------------------------------------


def _jax_moments(opt_state, batch_stats):
    """{port key: (mu, nu)} of every trained parameter in an optax
    multi_transform state (`batch_stats` tells the BatchNorm norms)."""
    out = {}
    for state in opt_state.inner_states.values():
        adam = [s for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        if not adam:
            continue  # the frozen group

        def unmasked(tree):
            if hasattr(tree, "items"):
                kept = {k: unmasked(v) for k, v in tree.items()}
                return {k: v for k, v in kept.items() if v is not None and len(v)}
            return None if isinstance(tree, optax.MaskedNode) else np.asarray(tree)

        def port_keys(tree):
            tree = unmasked(dict(tree))
            stats = {k: v for k, v in batch_stats.items() if k in tree}
            sd = state_dict_from_jax({"params": tree, "batch_stats": stats})
            return {k: v for k, v in sd.items() if "running_" not in k and "batches" not in k}

        mu, nu = port_keys(adam[0].mu), port_keys(adam[0].nu)
        out.update({k: (mu[k], nu[k]) for k in mu})
    return out


def _soft_labels():
    t = np.full((B, MODEL["num_classes"]), 0.02, np.float32)
    t[np.arange(B), LABELS] += 1.0 - t.sum(-1)
    return t


def _jax_steps(mode, mixup, steps=2):
    """Per step: (metrics, state_dict, Adam moments) of the JAX
    train step with its AdamW, from the schedule count EPOCH *
    STEPS_PER_EPOCH. The step is jitted once: its draws are the ones taken
    when it is traced, under the `same_draws` of the first step, and every
    later step repeats them (the port's steps each run under a fresh
    `same_draws` for that)."""
    cfg = _jax_cfg(mode)
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    variables = _jax_variables(mode)
    tx = jax_make_optimizer(cfg.train, STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=_set_schedule_count(tx.init(variables["params"]),
                                                     EPOCH * STEPS_PER_EPOCH),
                       batch_stats=variables.get("batch_stats", {}))
    step = jax_make_train_step(student, teacher, tx, cfg, mixup_active=mixup)
    labels = _soft_labels() if mixup else LABELS
    out = []
    for s in range(steps):
        args = (state, _teacher_params(), jnp.asarray(_images(70 + s)), jnp.asarray(labels),
                jax.random.PRNGKey(3 + s), jnp.float32(EPOCH))
        if s == 0:
            with same_draws():
                step = _compiled(step, *args)
        state, metrics = step(*args)
        sd = state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats})
        out.append(({k: float(v) for k, v in metrics.items()}, sd,
                    _jax_moments(state.opt_state, state.batch_stats)))
    return out


def _check_step(student, opt, want, lrs, before, first):
    """The port's parameters, Adam moments and BatchNorm statistics after a
    step against the JAX step's (see test_train_steps_match_jax); `before`:
    the parameters before it; `first`: whether it is the first update."""
    metrics, params, moments = want
    labels = label_params(student)
    g_floor = 1e-3 * max(np.abs(m).max() for m, _ in moments.values())
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            assert name not in moments
            np.testing.assert_array_equal(p.detach().numpy(), params[name], err_msg=name)
            continue
        st = opt.state[p]
        mu, nu = moments[name]
        scale = max(np.abs(mu).max(), g_floor)
        # a BatchNorm predictor's gradients carry the JAX layer's one-pass
        # batch variance (test_bn_predictor_matches_jax): 1e-3 there
        tol = 1e-3 if student.pruning.predictor_bn and "score_predictor" in name else 1e-4
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=0, atol=tol * scale,
                                   err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=0,
                                   atol=tol * max(nu.max(), g_floor ** 2), err_msg=name)
        lr, new = lrs[labels[name]], p.detach().numpy()
        if first:
            sure = np.abs(mu) > 1e-3 * scale
            np.testing.assert_allclose(new[sure], params[name][sure], rtol=0,
                                       atol=1e-2 * lr + 1e-12, err_msg=name)
        old = before[name].numpy()
        bound = 1.01 * lr * (np.sqrt(10.0) + 0.05 * np.abs(old))  # |m^ / sqrt(v^)| <= sqrt(10)
        assert (np.abs(new - old) <= bound + 1e-7).all(), name
    for k, v in student.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), params[k], rtol=0,
                                       atol=1e-4 * np.abs(params[k]).max(), err_msg=k)


@pytest.mark.parametrize("mode", FORWARD_MODES)
def test_train_steps_match_jax(mode):
    """Two train steps past the warmup against JAX's `make_train_step` with
    its AdamW: every metric (early_exit_loss among them) within 1e-5; after
    each step every Adam moment within 1e-4 of its tensor's largest
    magnitude (1e-3 for a BatchNorm predictor's, whose JAX batch variance
    loses digits: test_bn_predictor_matches_jax) (after the first, mu =
    0.1 g: the gradients; after the
    second, 0.09 g_1 + 0.1 g_2); after the first the parameters whose
    moment is above 1e-3 of that within 1e-2 * lr (a first Adam step is
    lr sign(g): below that its sign is rounding noise), after both every
    step within Adam's bound; a BatchNorm predictor's running
    statistics within 1e-4 of their largest magnitude (the layers after
    the first see inputs with the JAX batch variance's error), cls_token and pos_embed unchanged. The
    teacher-CLS student's predictors get no gradient and still decay, as
    optax decays them; random and teacher-CLS selection, the soft top-k
    indicator, dropout's masks and remat's recompute take the same draws
    on both sides."""
    mixup = mode == MIXUP_MODE
    student, teacher = _port(mode)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    labels = torch.from_numpy(_soft_labels() if mixup else LABELS)
    step = make_train_step(student, teacher, opt, cfg, mixup_active=mixup,
                           generator=torch.Generator())
    want = _jax_steps(mode, mixup)
    for s in range(2):
        before = {n: p.detach().clone() for n, p in student.named_parameters()}
        with same_draws():
            got = step(torch.from_numpy(_images(70 + s)), labels, EPOCH)
        assert set(got) == set(want[s][0])
        assert ("early_exit_loss" in got) == student.pruning.early_exit
        for k, v in want[s][0].items():
            np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, atol=1e-5, err_msg=k)
        _check_step(student, opt, want[s], {g["label"]: g["lr"] for g in opt.param_groups},
                    before, s == 0)
    if student.pruning.cls_from_teacher:
        grads = {n: p.grad for n, p in student.named_parameters() if "score_predictor" in n}
        assert grads and all(not g.any() for g in grads.values())


def test_train_step_updates_bn_stats_at_every_micro_step():
    """Under k=2 accumulation the running statistics move at both
    micro-steps (JAX's MultiSteps path carries batch_stats out of every
    call) while the parameters move at the second alone."""
    student, teacher = _port("bn_soft_topk_remat")
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(grad_accum_steps=2, **TRAIN))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    step = make_train_step(student, teacher, opt, cfg, generator=torch.Generator())
    key = "score_predictor.0.in_conv.0.bn.running_mean"
    before = student.state_dict()[key].clone()
    head = student.head.weight.detach().clone()
    step(torch.from_numpy(_images(70)), torch.from_numpy(LABELS), EPOCH)
    first = student.state_dict()[key].clone()
    assert not torch.equal(first, before) and torch.equal(student.head.weight, head)
    step(torch.from_numpy(_images(71)), torch.from_numpy(LABELS), EPOCH)
    assert not torch.equal(student.state_dict()[key], first)
    assert not torch.equal(student.head.weight, head)


# ---- the eval step ---------------------------------------------------------------


@pytest.mark.parametrize("mode", FORWARD_MODES)
def test_eval_step_matches_jax(mode):
    """JAX's `make_eval_step` against the port's on the same batch (4 rows
    of 5 valid): every metric within 1e-5. Random selection takes the same
    draws; the BatchNorm predictor its running statistics; the teacher-CLS
    student the teacher's rows in both forwards."""
    student, teacher = _port(mode)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning)
    jcfg = _jax_cfg(mode)
    variables = _jax_variables(mode)
    images = np.concatenate([_images(), _images(72)[:1]])
    labels = np.array([3, 7, 1, 0, -1])
    args = (variables["params"], variables.get("batch_stats", {}), _teacher_params(),
            jnp.asarray(images), jnp.asarray(labels))
    step = jax_make_eval_step(JaxStudent(cfg=jcfg.model, pruning=jcfg.pruning),
                              JaxTeacher(cfg=jcfg.model), jcfg)
    with same_draws():
        want = _compiled(step, *args)(*args)
        got = make_eval_step(student, teacher, cfg)(torch.from_numpy(images),
                                                    torch.from_numpy(labels))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_random_eval_is_a_fixed_draw_per_call():
    """Eval mode with random selection draws from a generator seeded with 0
    at each call (the JAX eval step's PRNGKey(0)): two calls keep the same
    tokens, and a train-mode call without a generator is refused."""
    student, _ = _port("random_dropout_early_exit")
    x = torch.from_numpy(_images())
    with torch.no_grad():
        a, b = student.eval()(x), student(x)
    for g, w in zip(a.kept_idx, b.kept_idx, strict=True):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="Generator"):
        student.train()(x)
    assert len(student.score_predictor) == 0


# ---- conversion, export, the registry ------------------------------------------------


def test_bn_and_early_exit_convert_both_ways():
    """A JAX student with the large BatchNorm predictor and the early-exit
    head: `state_dict_from_jax` gives the port's keys (the running
    statistics under `.bn.`), the port's state_dict taken back through the
    JAX package's `convert_student_state_dict` gives the same params and
    batch_stats, and its `export_student_state_dict` the same state_dict;
    every value bit-equal."""
    variables = _jax_variables("bn_large_early_exit")
    student, _ = _port("bn_large_early_exit")
    sd = {k: v.numpy() for k, v in student.state_dict().items()}
    assert "early_exit_head.1.weight" in sd
    assert "score_predictor.1.out_conv.12.bn.running_var" in sd
    back, loaded, skipped = convert_student_state_dict(sd, variables)
    assert all(k.endswith("num_batches_tracked") for k in skipped)
    for part in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_leaves_with_path(variables[part]))
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert set(got) == set(want)
        for path, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), v, err_msg=str(path))
    exported, passthrough = export_student_state_dict(variables, sd)
    assert all(k.endswith("num_batches_tracked") for k in passthrough)
    for k, v in sd.items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)


def test_bn_student_serves_with_its_running_stats(tmp_path):
    """A BatchNorm student with the early-exit head (2 blocks, one stage),
    its running statistics drawn away from their init, exported with
    `ServingModel` and loaded again: its logits within 1e-5 of the live
    eval model's (the exported graph computes the eval-mode batch norm as
    its own decomposition), which normalise with the running statistics,
    not the batch's: a batch of one gives the same row."""
    from dense2sparse_vit_torch.utils.serving import ServingModel

    student = create_model(STUDENT, device="cpu", img_size=32, patch_size=8, embed_dim=64,
                           depth=2, num_heads=1, num_classes=10, pruning_locs=(1,),
                           keep_ratios=(0.5,), predictor_bn=True, early_exit=True)
    rng = np.random.default_rng(64)
    with torch.no_grad():
        for k, v in student.state_dict().items():
            if "running_" in k:
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    student.eval()
    x = torch.from_numpy(_images())
    with torch.no_grad():
        live = student(x, collect_cls_attns=False).logits.float()
        single = student(x[:1], collect_cls_attns=False).logits.float()
    torch.testing.assert_close(single, live[:1], rtol=1e-5, atol=1e-5)
    sm = ServingModel.export(student, buckets=(B,), try_symbolic=False)
    sm.save(str(tmp_path))
    got = ServingModel.load(str(tmp_path))(x)
    torch.testing.assert_close(got, live, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["dino_small_student", "dino_tiny_student"])
def test_dino_students_match_the_jax_registry(name):
    """The pruning and model configs equal the JAX registry's, perturbed
    top-k on by default and off when asked."""
    for kw in ({}, {"differentiable_topk": False}):
        got = create_model(name, device="cpu", img_size=32, patch_size=8, depth=1, **kw)
        want = jax_create_model(name, img_size=32, patch_size=8, depth=1, **kw)
        assert got.pruning.differentiable_topk == (not kw)
        for part in ("cfg", "pruning"):
            g, w = getattr(got, part), getattr(want, part)
            for k in g.__dataclass_fields__:
                assert getattr(g, k) == getattr(w, k), (part, k)


# ---- remat ----------------------------------------------------------------------


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("kind", ["pruning", "gumbel"])
def test_remat_gradients_equal_the_plain_steps(kind):
    """One train step with remat and one without, from the same weights and
    generator seed: with DropPath, dropout and soft top-k noise (the
    pruning student) or DropPath and gumbel noise (the gumbel baseline)
    drawn from the generator, the recompute draws what the forward drew:
    loss and every gradient bit-equal, the generator left where the plain
    step leaves it."""
    results = []
    for remat in (False, True):
        if kind == "pruning":
            model, pruning = _fields("bn_soft_topk_remat")
            pruning = {**pruning, "predictor_bn": False}
            model = {**model, "drop_path_rate": 0.2, "drop_rate": 0.1, "remat": remat}
            student = create_model(STUDENT, device="cpu", **model, **pruning)
            build = make_train_step
        else:
            student = create_model("default_dynamic_vit_small_patch16_224_student",
                                   device="cpu", drop_path_rate=0.2, remat=remat,
                                   **MODEL, **PRUNING)
            build = make_dynamic_vit_train_step
        teacher = create_model(TEACHER, device="cpu", **MODEL)
        cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                               train=TrainConfig(**TRAIN))
        opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
        opt.count = EPOCH * STEPS_PER_EPOCH
        gen = torch.Generator().manual_seed(5)
        metrics = build(student, teacher, opt, cfg)(torch.from_numpy(_images()),
                                                   torch.from_numpy(LABELS), EPOCH,
                                                   generator=gen)
        results.append((metrics["loss"], _grads(student), gen.get_state()))
    (loss, grads, state), (r_loss, r_grads, r_state) = results
    assert torch.equal(loss, r_loss)
    assert set(grads) == set(r_grads) and grads
    for n in grads:
        assert torch.equal(grads[n], r_grads[n]), n
    assert torch.equal(state, r_state)


@pytest.mark.parametrize("attn_drop,core", [(0.0, "packed"), (0.1, "plain")])
def test_dropout_takes_the_jax_blocks_route(attn_drop, core):
    """On the CPU every wrapper runs its plain version; which kernels a mode
    launches is counted on the card (chip_smoke.py phase 33). Here, the
    route: a fused block in train mode with dropout leaves the whole-block
    wrapper and warns once; with attn_drop 0 it takes the packed
    attention's wrapper, with attn_drop > 0 plain attention; eval mode
    keeps the whole block."""
    calls = []
    real = (port_layers.fused_attention_packed_trainable, port_layers.fused_transformer_block,
            port_layers.fused_transformer_block_trainable)

    def spy(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)

    port_layers.fused_attention_packed_trainable = spy("packed", real[0])
    port_layers.fused_transformer_block = spy("block", real[1])
    port_layers.fused_transformer_block_trainable = spy("block_trainable", real[2])
    try:
        student = create_model(STUDENT, device="cpu", use_fused_attention=True, **MODEL,
                               **PRUNING, drop_rate=0.1, attn_drop_rate=attn_drop)
        x = torch.from_numpy(_images())
        with pytest.warns(UserWarning, match="elementwise dropout"):
            student.train()(x, collect_cls_attns=False, generator=torch.Generator())
        assert calls == (["packed"] * MODEL["depth"] if core == "packed" else [])
        calls.clear()
        with torch.no_grad():
            student.eval()(x, collect_cls_attns=False)
        assert calls == ["block"] * MODEL["depth"]
    finally:
        (port_layers.fused_attention_packed_trainable, port_layers.fused_transformer_block,
         port_layers.fused_transformer_block_trainable) = real
