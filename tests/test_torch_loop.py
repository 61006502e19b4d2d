"""Port parity of the training entry point: the train step's mixup and
teacher-cache paths, gradient accumulation, the teacher cache's outputs,
the curricula, checkpoints, the metrics log, the CLI and `run_experiment`
itself, dense2sparse_vit_torch against dense2sparse_vit_tpu.

A tiny student (depth 2, width 64, two pruning stages at blocks 0 and 1)
and teacher with the same weights (`utils.convert.state_dict_from_jax`),
fp32 on the CPU, plain (unfused) paths on both sides. Tolerances: metrics
within 1e-5, gradients within 1e-4 of their tensor's largest magnitude,
parameters after a loop within 1e-4; indices, counts and resumed runs
exact.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.cli as jax_cli
import dense2sparse_vit_tpu.models.dynamic_vit_default as jax_dvd
from dense2sparse_vit_tpu.core.config import DataConfig as JaxDataConfig
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.data.mixup import mixup_cutmix_batch as jax_mixup
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train import schedule as jax_schedule
from dense2sparse_vit_tpu.train.loop import run_experiment as jax_run_experiment
from dense2sparse_vit_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from dense2sparse_vit_tpu.train.teacher_cache import (
    make_teacher_outputs_fn as jax_teacher_outputs_fn,
)
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import (
    make_dynamic_vit_train_step as jax_make_dynamic_vit_train_step,
)
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step
from dense2sparse_vit_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from dense2sparse_vit_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from dense2sparse_vit_tpu.utils.logging import slurm_job_name as jax_slurm_job_name

import dense2sparse_vit_torch.ops.gumbel as port_gumbel
import dense2sparse_vit_torch.train.loop as loop
from dense2sparse_vit_torch import cli
from dense2sparse_vit_torch.core import DataConfig, ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.train import make_dynamic_vit_train_step, make_optimizer, make_train_step
from dense2sparse_vit_torch.train import schedule
from dense2sparse_vit_torch.train.teacher_cache import TeacherCache, make_teacher_outputs_fn
from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from dense2sparse_vit_torch.utils.logging import MetricsLogger, slurm_job_name
from test_torch_data import write_folder
from test_torch_dynamic_vit import _jax_keep_from, _port_noise
from test_torch_ops import REPO, load_numpy_state, random_like_tree
from test_torch_train_step import _grad_probe
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10)
PRUNING = dict(pruning_locs=(0, 1), keep_ratios=(0.7, 0.49), small_predictor=True)
GPRUNING = dict(pruning_locs=(0, 1), keep_ratios=(0.7, 0.49), selection="gumbel")
GUMBEL_LOSSES = dict(use_ratio_loss=True, use_token_dist_loss=True, teacher_cls_loss=True)
TRAIN = dict(epochs=10, warmup_epochs=0)
B, N, EPOCH = 4, 16, 1
NAMES = {"pruning": ("dynamic_vit_small_patch16_224_student", PRUNING),
         "gumbel": ("default_dynamic_vit_small_patch16_224_student", GPRUNING)}
TEACHER = "dynamic_vit_small_patch16_224_teacher"
# the small predictor's last LayerNorm bias and last Linear bias shift all of
# a sample's scores alike, which the softmax ignores: zero gradients in exact
# arithmetic (test_torch_train_step.py)
SHIFT_INVARIANT = ("out_conv.6.bias", "out_conv.7.bias")


def _batch(seed=30):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, MODEL["num_classes"], B))


def _jax_student(kind, cfg):
    if kind == "gumbel":
        return jax_dvd.DynamicViTStudent(cfg=cfg.model, pruning=cfg.pruning)
    return JaxStudent(cfg=cfg.model, pruning=cfg.pruning)


def _jax_cfg(kind, **train):
    losses = GUMBEL_LOSSES if kind == "gumbel" else {}
    return JaxExperimentConfig(
        model=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**NAMES[kind][1]),
        train=JaxTrainConfig(**{**TRAIN, **losses, **train}))


@functools.lru_cache(maxsize=None)
def _params(kind):
    cfg = _jax_cfg(kind)
    x1 = jnp.zeros((1, 32, 32, 3))
    s = jax.eval_shape(_jax_student(kind, cfg).init, jax.random.PRNGKey(0), x1)
    t = jax.eval_shape(JaxTeacher(cfg=cfg.model).init, jax.random.PRNGKey(1), x1)
    return random_like_tree(s["params"], seed=61), random_like_tree(t["params"], seed=62)


def _noise(seed=63):
    rng = np.random.default_rng(seed)
    return [np.maximum(rng.random((B, N, 2)), 1e-20).astype(np.float32) for _ in range(2)]


def _port(kind, **train):
    name, pruning = NAMES[kind]
    student = create_model(name, device="cpu", **MODEL, **pruning)
    teacher = create_model(TEACHER, device="cpu", **MODEL)
    sparams, tparams = _params(kind)
    load_numpy_state(student, state_dict_from_jax(sparams))
    load_numpy_state(teacher, state_dict_from_jax(tparams))
    losses = GUMBEL_LOSSES if kind == "gumbel" else {}
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**{**TRAIN, **losses, **train}))
    return student, teacher, cfg


def _inputs(mode):
    """(images, labels or soft targets, JAX teacher rows or None), numpy."""
    images, labels = _batch()
    if mode == "mixup":
        x, t = jax_mixup(jax.random.PRNGKey(64), jnp.asarray(images), jnp.asarray(labels),
                         MODEL["num_classes"])
        return np.asarray(x), np.asarray(t)
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_step(kind, mode):
    """(metrics, gradients, teacher rows) of one JAX step, kind 'pruning'
    or 'gumbel', mode 'mixup' (soft targets) or 'cached' (teacher rows)."""
    cfg = _jax_cfg(kind)
    student, teacher = _jax_student(kind, cfg), JaxTeacher(cfg=cfg.model)
    sparams, tparams = _params(kind)
    images, labels = _inputs(mode)
    rows = None
    teacher_in = tparams
    if mode == "cached":
        rows = jax_teacher_outputs_fn(teacher, cfg)(tparams, jnp.asarray(images))
        teacher_in = rows
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=sparams, batch_stats={},
                       opt_state=probe.init(sparams))
    make = jax_make_dynamic_vit_train_step if kind == "gumbel" else jax_make_train_step
    step = jax.jit(make(student, teacher, probe, cfg, mixup_active=mode == "mixup",
                        cached_teacher=mode == "cached"))

    def go():
        return step(state, teacher_in, jnp.asarray(images), jnp.asarray(labels),
                    jax.random.PRNGKey(3), jnp.float32(EPOCH))

    if kind == "gumbel":
        real = jax_dvd.gumbel_softmax_keep
        jax_dvd.gumbel_softmax_keep = _jax_keep_from(_noise())
        try:
            probed, metrics = go()
        finally:
            jax_dvd.gumbel_softmax_keep = real
    else:
        probed, metrics = go()
    rows = None if rows is None else {k: np.asarray(v) for k, v in rows.items()}
    return ({k: float(v) for k, v in metrics.items()}, state_dict_from_jax(probed.opt_state),
            rows)


@pytest.mark.parametrize("kind", ["pruning", "gumbel"])
@pytest.mark.parametrize("mode", ["mixup", "cached"])
def test_train_step_matches_jax_under_mixup_and_the_teacher_cache(monkeypatch, kind, mode):
    """One step past warmup: metrics within 1e-5, every gradient within
    1e-4 of its tensor's largest magnitude (against a floor of 1e-3 of the
    model's largest gradient, as in test_torch_train_step.py). mixup: the
    batch mixed by JAX's mixup, the labels its soft targets. cached: the
    teacher's rows from JAX's make_teacher_outputs_fn, and no teacher
    forward in the step (the teacher's weights are zeroed to show it)."""
    metrics, grads, rows = _jax_step(kind, mode)
    monkeypatch.setattr(port_gumbel, "uniform_noise", _port_noise(_noise()))
    student, teacher, cfg = _port(kind)
    images, labels = (torch.from_numpy(np.asarray(v)) for v in _inputs(mode))
    teacher_in = None
    if mode == "cached":
        teacher_in = {k: torch.from_numpy(v) for k, v in rows.items()}
        with torch.no_grad():
            for p in teacher.parameters():
                p.zero_()
    make = make_dynamic_vit_train_step if kind == "gumbel" else make_train_step
    step = make(student, teacher, make_optimizer(student, cfg.train, 3), cfg,
                mixup_active=mode == "mixup", cached_teacher=mode == "cached")
    got = step(images, labels, EPOCH, teacher_in=teacher_in, generator=torch.Generator())
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), metrics[k], rtol=1e-5, atol=1e-5, err_msg=k)
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    for name, p in student.named_parameters():
        if p.grad is None:
            assert not np.abs(grads[name]).any(), name
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_a_cached_step_needs_its_rows():
    student, teacher, cfg = _port("pruning")
    step = make_train_step(student, teacher, make_optimizer(student, cfg.train, 3), cfg,
                           cached_teacher=True)
    with pytest.raises(ValueError, match="teacher_in"):
        step(torch.from_numpy(_batch()[0]), torch.from_numpy(_batch()[1]), EPOCH)


def test_two_micro_steps_match_jax_multisteps():
    """grad_accum_steps=2: the first micro-step leaves every parameter as
    it was, on both sides; the second applies AdamW to the two gradients'
    mean, within 1e-2 * lr of the JAX package's MultiSteps update where the
    mean's sign is sure (a first Adam step moves a parameter by about lr *
    sign(g); sure: above 1e-3 of its tensor's largest, floored at 1e-3 of
    the model's, as in test_torch_train_step.py); the update count is 1
    after the two."""
    cfg = _jax_cfg("pruning", grad_accum_steps=2)
    student, teacher = _jax_student("pruning", cfg), JaxTeacher(cfg=cfg.model)
    sparams, tparams = _params("pruning")
    tx = jax_build_optimizer(cfg.train, 3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=sparams, batch_stats={},
                       opt_state=tx.init(sparams))
    step = jax.jit(jax_make_train_step(student, teacher, tx, cfg))
    batches = [_batch(31), _batch(32)]
    states = []
    for x, y in batches:
        state, _ = step(state, tparams, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(3),
                        jnp.float32(EPOCH))
        states.append(state_dict_from_jax(state.params))
    start = state_dict_from_jax(sparams)
    assert all(np.array_equal(states[0][k], start[k]) for k in start)

    pstudent, pteacher, pcfg = _port("pruning", grad_accum_steps=2)
    opt = make_optimizer(pstudent, pcfg.train, 3)
    pstep = make_train_step(pstudent, pteacher, opt, pcfg)
    before = {k: v.clone() for k, v in pstudent.state_dict().items()}
    grads = []
    for i, (x, y) in enumerate(batches):
        pstep(torch.from_numpy(x), torch.from_numpy(y), EPOCH)
        grads.append({n: p.grad.clone() for n, p in pstudent.named_parameters()
                      if p.grad is not None})
        if i == 0:
            assert all(torch.equal(v, before[k]) for k, v in pstudent.state_dict().items())
            assert opt.count == 0 and opt.mini_step == 1
    assert opt.count == 1 and opt.mini_step == 0 and not opt.accum
    lrs = {g["label"]: g["lr"] for g in opt.param_groups}
    labels = {n: g["label"] for g in opt.param_groups for n, p in pstudent.named_parameters()
              if any(p is q for q in g["params"])}
    means = {n: (grads[0][n] + grads[1][n]).numpy() / 2 for n in grads[0]}
    # gradients that are zero in exact arithmetic (a bias shifting all of a
    # sample's scores alike) are rounding noise: held to the model's floor
    floor = 1e-3 * max(np.abs(v).max() for v in means.values())
    moved = 0
    for name, p in pstudent.named_parameters():
        if name not in labels:  # frozen
            assert torch.equal(p, before[name]), name
            continue
        mean = means[name]
        sure = np.abs(mean) > 1e-3 * max(np.abs(mean).max(), floor)
        np.testing.assert_allclose(p.detach().numpy()[sure], states[1][name][sure], rtol=0,
                                   atol=1e-2 * lrs[labels[name]] + 1e-12, err_msg=name)
        moved += int(not torch.equal(p, before[name]))
    assert moved == len(labels)


@pytest.mark.parametrize("kind", ["pruning", "gumbel"])
def test_teacher_outputs_fn_matches_jax(kind):
    """Keys and values (fp32) of the cacheable teacher outputs: logits,
    target, and token_probs + token_entropy, or raw tokens for the gumbel
    baseline; uint8 images are normalised first."""
    cfg = _jax_cfg(kind)
    _, tparams = _params(kind)
    images = np.random.default_rng(65).integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    want = jax_teacher_outputs_fn(JaxTeacher(cfg=cfg.model), cfg)(tparams, jnp.asarray(images))
    _, teacher, pcfg = _port(kind)
    got = make_teacher_outputs_fn(teacher, pcfg)(torch.from_numpy(images))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_teacher_cache_builds_pads_and_looks_up(folder_loader):
    """The pre-pass pads a short last batch and drops the pad rows; host
    and device lookups give the rows of the indices asked for."""
    loader, n = folder_loader
    _, teacher, cfg = _port("pruning")
    fn = make_teacher_outputs_fn(teacher, cfg)
    cache = TeacherCache(range(n))
    cache.build(fn, lambda: loader(0), 4, "cpu", cache_images=True)
    assert cache.filled.all() and not cache.on_device
    sel = [5, 0, n - 1]
    host = cache.lookup(sel)
    xb = torch.stack([host["images"][i] for i in range(3)])
    want = fn(xb)
    for k, v in want.items():
        np.testing.assert_allclose(host[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert cache.to_device("cpu") and cache.device_has_images and cache.device_nbytes > 0
    dev = cache.lookup_device(sel)
    assert all(torch.equal(dev[k], host[k]) for k in host)
    small = TeacherCache(range(n))
    small.build(fn, lambda: loader(0), 4, "cpu", cache_images=True)
    # over the budget with the images, under it without: the rows move alone
    assert small.to_device("cpu", limit_bytes=small.nbytes - 1) and not small.device_has_images


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop_images"))
    write_folder(root, classes=5, images=10)
    return root


@pytest.fixture
def folder_loader(folder):
    from dense2sparse_vit_torch.data import ImageFolder, eval_transform, make_loader

    ds = ImageFolder(folder, eval_transform(DataConfig(eval_resize=36, eval_crop=32), False))
    return make_loader(ds, 4, drop_last=False, with_indices=True, as_uint8=True), len(ds)


@pytest.mark.parametrize("epoch", [0, 45, 90, 120])
def test_curricula_match_jax(epoch):
    for e in (epoch, torch.tensor(float(epoch))):
        np.testing.assert_allclose(float(schedule.current_keep_ratio(e)),
                                   float(jax_schedule.current_keep_ratio(epoch)), rtol=1e-6)
        np.testing.assert_allclose(float(schedule.current_patch_score_threshold(e)),
                                   float(jax_schedule.current_patch_score_threshold(epoch)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(schedule.current_keep_ratio(e, 0.5, 30)),
                                   float(jax_schedule.current_keep_ratio(epoch, 0.5, 30)),
                                   rtol=1e-6)


def test_checkpoint_managers_agree_and_restore_exactly(tmp_path):
    """The same save / save_if_best sequence through JAX's manager and the
    port's: after a re-open, the same latest and best steps and best
    metric. Then a mid-cycle state (grad_accum_steps=2, three micro-steps:
    one update, one gradient in the accumulator) restores bit for bit, and
    the next micro-step from it equals the one from the original."""
    seq = [(2, 0.1), (4, 0.3), (6, 0.2), (8, 0.4), (10, 0.35)]
    jm, pm = JaxCheckpointManager(str(tmp_path / "jax")), CheckpointManager(str(tmp_path / "pt"))
    for step, metric in seq:
        state = {"w": np.full((3,), step, np.float32)}
        jm.save(step, state)
        pm.save(step, {"w": torch.from_numpy(state["w"])})
        assert jm.save_if_best(step, state, metric) == pm.save_if_best(
            step, {"w": torch.from_numpy(state["w"])}, metric)
    jm.close()
    jm, pm = JaxCheckpointManager(str(tmp_path / "jax")), CheckpointManager(str(tmp_path / "pt"))
    assert (jm.latest_step(), jm.best_step(), jm.best_metric) == (
        pm.latest_step(), pm.best_step(), pm.best_metric) == (10, 8, 0.4)
    assert float(pm.restore_best()["w"][0]) == 8 and float(pm.restore()["w"][0]) == 10
    assert sorted(os.listdir(tmp_path / "pt" / "latest")) == [
        "step_10.json", "step_10.pt", "step_8.json", "step_8.pt"]
    assert len(os.listdir(tmp_path / "pt" / "best")) == 6  # max_to_keep 3
    pm.save(10, {"w": torch.zeros(3)})  # a step already saved is not saved again
    assert float(pm.restore(10)["w"][0]) == 10
    jm.close()

    def build():
        student, teacher, cfg = _port("pruning", grad_accum_steps=2)
        opt = make_optimizer(student, cfg.train, 3)
        return student, opt, make_train_step(student, teacher, opt, cfg)

    student, opt, step = build()
    for s in (31, 32, 33):
        step(*(torch.from_numpy(v) for v in _batch(s)), EPOCH)
    assert (opt.count, opt.mini_step) == (1, 1) and opt.accum
    CheckpointManager(str(tmp_path / "mid")).save(
        3, {"student": student.state_dict(), "optimizer": opt.state_dict(), "step": 3})
    got = CheckpointManager(str(tmp_path / "mid")).restore()
    student2, opt2, step2 = build()
    student2.load_state_dict(got["student"])
    opt2.load_state_dict(got["optimizer"])
    assert (opt2.count, opt2.mini_step, got["step"]) == (1, 1, 3)
    params = dict(student.named_parameters())
    accum = {n: opt2.accum[p] for n, p in student2.named_parameters() if p in opt2.accum}
    assert len(accum) == len(opt.accum)
    assert all(torch.equal(a, opt.accum[params[n]]) for n, a in accum.items())
    x, y = (torch.from_numpy(v) for v in _batch(34))
    step(x, y, EPOCH)
    step2(x, y, EPOCH)
    assert opt.count == opt2.count == 2
    for (n, a), (_, b) in zip(student.state_dict().items(), student2.state_dict().items()):
        assert torch.equal(a, b), n


def test_metrics_logger_writes_the_jax_loggers_records(tmp_path):
    loggers = [JaxMetricsLogger(str(tmp_path / "jax"), "job"),
               MetricsLogger(str(tmp_path / "pt"), "job")]
    for lg in loggers:
        lg.log({"loss": 1.5, "acc": np.float32(0.25)}, 3, prefix="train")
        lg.log({"epoch_seconds": 2.0}, 0, prefix="time")
        lg.log({"plain": 7}, 4)
        lg.summary({"best_val_acc": 0.5, "epochs": 2})
        lg.close()
    recs = []
    for d in ("jax", "pt"):
        with open(tmp_path / d / "metrics.jsonl") as f:
            recs.append([{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in f])
    assert recs[0] == recs[1] and recs[1][0] == {"step": 3, "train/loss": 1.5, "train/acc": 0.25}
    with open(tmp_path / "jax" / "summary.json") as a, open(tmp_path / "pt" / "summary.json") as b:
        assert json.load(a) == json.load(b)


ARGVS = [
    [],
    "--dtype bfloat16 --pruning-locs 3 6 9 --keep-ratios 0.7 0.49 0.343 --small-predictor "
    "--topk-selection --use-fused-attention --batch-size 128 --warmup-steps 1".split(),
    "--dynamic-vit-baseline --use-ratio-loss --ratio-weight 3 --use-token-dist-loss "
    "--teacher-cls-loss --softmax-temp 2 --cls-weight 0.5 --dist-weight 0.7".split(),
    "--attn-selection --mean-heads --arch deit_tiny --epochs 3 --lr 1e-3 --min-lr 1e-6".split(),
    "--teacher-cache --device-cache-gb 2 --grad-accum-steps 4 --no-flat-optimizer --mixup 0 "
    "--cutmix 0 --seed 7 --warmup-lr 2e-6 --weight-decay 0.1 --freeze-backbone".split(),
    "--cutmix-minmax 0.2 0.8 --mixup-mode pair --no-repeated-aug --reprob 0.5 --recount 2 "
    "--aa rand-m7-mstd0.5 --smoothing 0.2 --mixup-prob 0.5 --mixup-switch-prob 0.3".split(),
    "--patch-score-threshold 0.5 --quant int8 --use-fused-attention --mask-loss-type mse "
    "--img-size 32 --eval-crop 32 --eval-resize 36 --patch-size 8 "
    "--num-classes 10 --arch deit_base --imgnet-val-dir /x --save-path s/ --wandb".split(),
]


def _fields(obj):
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_config_matches_jax(argv):
    """Every field of the port's config takes the JAX CLI's value for the
    same flags (--device is the port's own)."""
    got, args = cli.parse_config(argv + ["--device", "cpu"])
    want, _ = jax_cli.parse_config(argv)
    assert args.device == "cpu"
    for part in ("model", "pruning", "train", "data"):
        g, w = getattr(got, part), getattr(want, part)
        for k, v in _fields(g).items():
            assert v == getattr(w, k), (part, k)
    for k, v in _fields(got).items():
        if k not in ("model", "pruning", "train", "data"):
            assert v == getattr(want, k), k
    assert slurm_job_name(got) == jax_slurm_job_name(want)


@pytest.mark.parametrize("argv,name", [
    (["--remat"], "--remat"),
    (["--initial-sigma", "0.1"], "--initial-sigma"),
    (["--dist-coordinator", "host:1234"], "more than one process"),
    (["--dist-num-processes", "2"], "more than one process"),
])
def test_unported_flags_raise_naming_themselves(argv, name):
    """--remat and --initial-sigma are ported now: they reach the config as
    the JAX CLI's do. More than one process is ported too: the --dist-*
    flags parse, into the same config as without them, and reach main's
    `maybe_initialize_distributed` (tests/test_torch_distributed.py runs
    them)."""
    if name.startswith("--"):
        got, _ = cli.parse_config(argv)
        want, _ = jax_cli.parse_config(argv)
        assert got.model.remat == want.model.remat == (name == "--remat")
        assert got.pruning.initial_sigma == want.pruning.initial_sigma
        assert got.pruning.initial_sigma == (0.1 if name == "--initial-sigma" else 0.05)
        return
    got, args = cli.parse_config(argv)
    want, jargs = jax_cli.parse_config(argv)
    assert got == cli.parse_config([])[0]
    assert (args.dist_coordinator, args.dist_num_processes) == (
        jargs.dist_coordinator, jargs.dist_num_processes)


@pytest.mark.parametrize("flag,name", [
    ("--visualize-patch-drop", "visualize_patch_drop"),
    ("--visualize-cls-attn-evo", "visualize_cls_attn_evo"),
    ("--random-drop", "random"),
    ("--cls-from-teacher", "cls_from_teacher"),
    ("--early-exit", "early_exit"),
])
def test_unported_features_raise_in_the_loop(folder, tmp_path, flag, name):
    """Every one of these is ported now. --visualize-patch-drop and
    --visualize-cls-attn-evo: one epoch of one step writes its picture under
    workdir/viz, and the student trains bit-equal to the same run without
    the flag. --random-drop, --cls-from-teacher and --early-exit: one epoch
    of one step runs through run_experiment and its eval, and the summary is
    finite."""
    cfg, _ = cli.parse_config(_small_argv(folder, "--epochs", "1") + [flag])
    if name.startswith("visualize"):
        assert getattr(cfg, name)
        plain, _ = cli.parse_config(_small_argv(folder, "--epochs", "1"))
        for c, sub in ((cfg, "viz_run"), (plain, "plain_run")):
            summary = loop.run_experiment(c, str(tmp_path / sub), device="cpu",
                                          max_steps_per_epoch=1)
            assert np.isfinite(summary["best_val_acc"])
        png = {"visualize_patch_drop": "patch_drop_epoch_0.png",
               "visualize_cls_attn_evo": "cls_attn_evo_epoch_0.png"}[name]
        assert os.listdir(tmp_path / "viz_run" / "viz") == [png]
        assert not os.path.exists(tmp_path / "plain_run" / "viz")
        a, b = (CheckpointManager(str(tmp_path / sub / "ckpt")).restore()["student"]
                for sub in ("viz_run", "plain_run"))
        assert all(torch.equal(a[k], b[k]) for k in b)
        return
    assert {"random": cfg.pruning.selection == "random",
            "cls_from_teacher": cfg.pruning.cls_from_teacher,
            "early_exit": cfg.pruning.early_exit}[name]
    summary = loop.run_experiment(cfg, str(tmp_path), device="cpu", max_steps_per_epoch=1)
    assert summary["epochs"] == 1 and np.isfinite(summary["best_val_acc"])


def test_the_loop_refuses_what_it_cannot_do(folder, tmp_path):
    cfg, _ = cli.parse_config(_small_argv(folder) + ["--teacher-cache"])
    with pytest.raises(ValueError, match="mixup"):
        loop.run_experiment(cfg, str(tmp_path / "a"), device="cpu")
    cfg, _ = cli.parse_config(_small_argv(folder))
    with pytest.raises(FileNotFoundError, match="eval-only"):
        loop.run_experiment(cfg, str(tmp_path / "b"), device="cpu", eval_only=True, resume=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loop.run_experiment(cfg, str(tmp_path / "c"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(_small_argv(folder) + ["--workdir", str(tmp_path / "d"), "--device", "cuda"])


def test_cli_help_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"  # any import of jax now fails
            "sys.argv = ['cli', '--help']\n"
            "try:\n"
            "    runpy.run_module('dense2sparse_vit_torch.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.startswith(('jax.', 'flax', "
            "'dense2sparse_vit_tpu')))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device" in out.stdout and "--teacher-cache" in out.stdout


# ---- run_experiment ------------------------------------------------------------


def _small_argv(folder, *extra):
    return [
        "--imgnet-val-dir", folder, "--img-size", "32", "--eval-crop", "32",
        "--eval-resize", "36", "--patch-size", "8", "--num-classes", "10", "--arch", "deit_tiny", "--pruning-locs", "0", "1", "--keep-ratios", "0.7", "0.49",
        "--small-predictor", "--batch-size", "8", "--warmup-steps", "1", "--seed", "0",
        *extra]


def _loop_cfg(folder, **train):
    """The JAX and the port's config of the parity loop: fp32, top-k,
    --teacher-cache without mixup, 2 epochs of 2 steps at B=8 (40 train,
    10 val images: a full val batch and a padded one of 2)."""
    kw = dict(batch_size=8, epochs=2, warmup_epochs=1, teacher_cache=True, seed=0, **train)
    data = dict(imgnet_val_dir=folder, num_classes=10, eval_resize=36, eval_crop=32, mixup=0.0,
                cutmix=0.0)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL),
                               pruning=JaxPruningConfig(**PRUNING),
                               train=JaxTrainConfig(**kw), data=JaxDataConfig(**data))
    pcfg = ExperimentConfig(model=_port("pruning")[2].model, pruning=_port("pruning")[2].pruning,
                            train=TrainConfig(**kw), data=DataConfig(**data))
    return jcfg, pcfg


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_run_experiment_matches_jax(folder, tmp_path):
    """The loop of both packages on the deterministic teacher-cache path
    (no random draw anywhere), from the same weights: every logged train
    and val metric and every final student parameter within 1e-4 (the two
    SHIFT_INVARIANT biases, whose gradients are rounding noise, held to the
    size of four Adam steps on both sides), the same best_val_acc, and the
    port's checkpoint at the JAX step count."""
    jcfg, pcfg = _loop_cfg(folder)
    sparams, tparams = _params("pruning")
    want = jax_run_experiment(jcfg, str(tmp_path / "jax"), teacher_params=tparams,
                              student_params=sparams, max_steps_per_epoch=2)
    got = loop.run_experiment(pcfg, str(tmp_path / "pt"), teacher_params=state_dict_from_jax(
        tparams), student_params=state_dict_from_jax(sparams), max_steps_per_epoch=2,
        device="cpu")
    assert got["best_val_acc"] == want["best_val_acc"]
    assert got["train_device_resident"] and want["train_device_resident"]
    jrec, prec = _records(str(tmp_path / "jax")), _records(str(tmp_path / "pt"))
    jrec = [r for r in jrec if not any(k.startswith("time/") for k in r)]
    prec = [r for r in prec if not any(k.startswith("time/") for k in r)]
    assert [sorted(r) for r in jrec] == [sorted(r) for r in prec] and len(prec) == 4
    for j, p in zip(jrec, prec):
        for k, v in j.items():
            if k != "time":
                np.testing.assert_allclose(p[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
    jm = JaxCheckpointManager(str(tmp_path / "jax" / "ckpt"))
    jstate = jm._latest.restore(jm.latest_step(), args=__import__(
        "orbax.checkpoint", fromlist=["args"]).args.StandardRestore())
    jm.close()
    final = CheckpointManager(str(tmp_path / "pt" / "ckpt")).restore()
    assert final["step"] == int(jstate["step"]) == 4
    want_params = state_dict_from_jax(jstate["params"])
    start = state_dict_from_jax(sparams)
    lr = pcfg.train.lr
    for k, v in final["student"].items():
        if k.endswith(SHIFT_INVARIANT):
            # its gradient is rounding noise on both sides: each Adam step
            # moves it by about lr * sign(noise); held to that size
            bound = 4 * 1.01 * lr * (1 + pcfg.train.weight_decay * np.abs(start[k]))
            for got in (v.numpy(), want_params[k]):
                assert (np.abs(got - start[k]) <= bound + 1e-7).all(), k
            continue
        np.testing.assert_allclose(v.numpy(), want_params[k], rtol=0, atol=1e-4, err_msg=k)


def test_resume_equals_an_uninterrupted_run(folder, tmp_path, monkeypatch):
    """The default recipe (RandAugment, random erasing, mixup and cutmix)
    for 3 epochs of 2 steps, straight, against the same run preempted after
    its second epoch (its next step raises) and resumed: the student, the
    optimizer's moments and count and the step count bit for bit, the best
    metric equal."""
    argv = _small_argv(folder, "--epochs", "3", "--mixup-mode", "elem")
    cfg, _ = cli.parse_config(argv)
    straight = loop.run_experiment(cfg, str(tmp_path / "a"), device="cpu",
                                   max_steps_per_epoch=2)

    class Preempted(Exception):
        pass

    real = loop.make_train_step

    def preempting(*a, **k):
        step, calls = real(*a, **k), []

        def counted(*args, **kw):
            if len(calls) == 4:
                raise Preempted
            calls.append(1)
            return step(*args, **kw)
        return counted

    monkeypatch.setattr(loop, "make_train_step", preempting)
    with pytest.raises(Preempted):
        loop.run_experiment(cfg, str(tmp_path / "b"), device="cpu", max_steps_per_epoch=2)
    monkeypatch.setattr(loop, "make_train_step", real)
    resumed = loop.run_experiment(cfg, str(tmp_path / "b"), device="cpu", max_steps_per_epoch=2,
                                  resume=True)
    assert resumed == straight
    a = CheckpointManager(str(tmp_path / "a" / "ckpt"))
    b = CheckpointManager(str(tmp_path / "b" / "ckpt"))
    assert a.best_metric == b.best_metric and a.latest_step() == b.latest_step() == 6
    sa, sb = a.restore(), b.restore()
    assert sa["step"] == sb["step"] == 6
    assert sa["optimizer"]["schedule"]["count"] == sb["optimizer"]["schedule"]["count"] == 6
    for k in sa["student"]:
        assert torch.equal(sa["student"][k], sb["student"][k]), k
    for i, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["optimizer"]["state"][i][k]), (i, k)
    # the augmented stream is really drawn: a different seed trains differently
    other, _ = cli.parse_config(argv[:-2] + ["--seed", "1", "--mixup-mode", "elem"])
    loop.run_experiment(other, str(tmp_path / "c"), device="cpu", max_steps_per_epoch=2)
    sc = CheckpointManager(str(tmp_path / "c" / "ckpt")).restore()
    assert not torch.equal(sc["student"]["head.weight"], sa["student"]["head.weight"])


def test_eval_only_export_and_grad_accumulation_through_the_cli(folder, tmp_path):
    """`cli.main` end to end: a run with --grad-accum-steps 2 (an update
    every second micro-step: count = steps / 2), then --eval-only with
    --export-serving on its workdir, whose artifact serves the best
    checkpoint's logits."""
    from dense2sparse_vit_torch.data import device_normalize
    from dense2sparse_vit_torch.models import DiffPruningStudent
    from dense2sparse_vit_torch.utils.serving import ServingModel

    wd, exp = str(tmp_path / "run"), str(tmp_path / "serving")
    base = _small_argv(folder, "--workdir", wd, "--device", "cpu", "--epochs", "2")
    summary = cli.main(base + ["--grad-accum-steps", "2"])
    assert summary["epochs"] == 2
    state = CheckpointManager(os.path.join(wd, "ckpt")).restore()
    assert state["step"] == 10 and state["optimizer"]["schedule"]["count"] == 5
    ev = cli.main(base + ["--eval-only", "--export-serving", exp])
    assert ev["eval_only"] and "val_acc" in ev
    cfg, _ = cli.parse_config(base)
    best = CheckpointManager(os.path.join(wd, "ckpt")).restore_best()
    live = DiffPruningStudent(cfg.model, cfg.pruning)
    live.load_state_dict(best["student"])
    x = device_normalize(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 32, 32, 3), dtype=np.uint8)), cfg.data)
    with torch.no_grad():
        want = live.eval()(x, collect_cls_attns=False).logits.float()
    np.testing.assert_allclose(ServingModel.load(exp)(x).numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
