"""Data and tensor parallelism of the port on the CPU: two gloo ranks (one
torch thread each) against one process on the global batch and against
the JAX package's step, `run_experiment` and the CLI on two ranks, and the
four-rank dry run.

A spawn costs seconds, so each module fixture spawns once and its ranks
run every check, returning what they saw to this process (a file a rank);
each check stays a test of its own. The ranks import this module without
JAX: the JAX side runs here, lazily imported. The rule held: for the
deterministic modes, N ranks of B/N samples compute what one process
computes on the global batch of B, within fp32 reduction order.
"""

import copy
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.core.mesh import (
    free_port,
    local_rows,
    make_mesh,
    maybe_initialize_distributed,
)
from dense2sparse_vit_torch.parallel import global_batch_metrics
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=10)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.5,), small_predictor=True)
TRAIN = dict(epochs=10, warmup_epochs=5)
EPOCH, STEPS_PER_EPOCH, B, WORLD = 6, 3, 4, 2
LABELS = np.array([3, 7, 1, 0])
STUDENT = "dynamic_vit_small_patch16_224_student"
TEACHER = "dynamic_vit_small_patch16_224_teacher"
# the small predictor's last LayerNorm bias and last Linear bias shift all of
# a sample's scores alike, which the softmax ignores: zero gradients in exact
# arithmetic, rounding noise in practice (test_torch_train_step.py)
SHIFT_INVARIANT = ("out_conv.6.bias", "out_conv.6.bn.bias", "out_conv.7.bias")


def _images(seed=20):
    return np.random.default_rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _spawn(fn, nprocs, *args, timeout=300):
    """Run fn(rank, *args) in `nprocs` spawned processes; raises if one
    fails or the whole outlasts `timeout` seconds (its processes killed)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.time() + timeout
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {timeout} s")


def _join(rank, port):
    torch.set_num_threads(1)
    maybe_initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device_type="cpu",
                                 timeout=datetime.timedelta(seconds=120))


# ---- the ranks' side ---------------------------------------------------------


def _port(weights, bn=False):
    from dense2sparse_vit_torch.models import create_model

    student = create_model(STUDENT, device="cpu", **MODEL, **PRUNING, predictor_bn=bn)
    student.load_state_dict({k: torch.from_numpy(v) for k, v in weights[
        "bn" if bn else "student"].items()})
    teacher = create_model(TEACHER, device="cpu", **MODEL)
    teacher.load_state_dict({k: torch.from_numpy(v) for k, v in weights["teacher"].items()})
    return student, teacher


def _snapshot(student, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.detach().clone() for n, p in student.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in student.named_parameters()},
            "stats": {n: b.clone() for n, b in student.named_buffers() if "running" in n}}


def _train_step(rank, mesh, weights, bn):
    """One top-k step (with the BatchNorm predictor where bn) under DDP on
    this rank's half of the batch; on rank 0 also the one-process step."""
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step
    from dense2sparse_vit_torch.train.train_step import wrap_ddp

    student, teacher = _port(weights, bn)
    single = copy.deepcopy(student)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    x, y = torch.from_numpy(_images()), torch.from_numpy(LABELS)
    out = {}
    for model, key, wrap in ((student, "ddp", True), (single, "single", False)):
        if key == "single" and rank != 0:
            continue
        opt = make_optimizer(model, cfg.train, STEPS_PER_EPOCH)
        opt.count = EPOCH * STEPS_PER_EPOCH
        if wrap:
            m = make_train_step(wrap_ddp(model, cfg, mesh), teacher, opt, cfg)(
                local_rows(x, mesh), local_rows(y, mesh), EPOCH)
            m = global_batch_metrics(m, mesh.data_group)
        else:
            m = make_train_step(model, teacher, opt, cfg)(x, y, EPOCH)
        out[key] = _snapshot(model, m)
        out[key]["lrs"] = {g["label"]: g["lr"] for g in opt.param_groups}
    return out


def _denominators(rank, mesh):
    """Both kept-token denominators with unequal keep counts per rank: a
    tiny linear map under DDP feeds the threshold mode's token KL
    (`backbone_loss`) and the gumbel baseline's token MSE
    (`dynamic_vit_distill_loss`); the averaged gradient and the mean of the
    ranks' losses, with the group and (to show the coupling) without it,
    and on rank 0 the one-process values on all four samples."""
    from dense2sparse_vit_torch.losses import backbone_loss, dynamic_vit_distill_loss

    rng = np.random.default_rng(40)
    feats = torch.from_numpy(rng.standard_normal((B, 6, 8)).astype(np.float32))
    t_tokens = torch.from_numpy(rng.standard_normal((B, 6, 8)).astype(np.float32))
    t_logits = torch.from_numpy(rng.standard_normal((B, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 8, B))
    keep = torch.zeros(B, 6)
    for i, n in enumerate((6, 5, 1, 2)):  # rank 0 keeps 11 tokens, rank 1 keeps 3
        keep[i, :n] = 1.0
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 8)

    def run(module, rows, group):
        tok = module(feats[rows])
        logits = tok.mean(1)
        bl, bm = backbone_loss(logits, tok, t_logits[rows], t_tokens[rows], labels[rows],
                               keep_mask=keep[rows], group=group)
        dl, dm = dynamic_vit_distill_loss(logits, tok, t_logits[rows], t_tokens[rows],
                                          labels[rows], [], keep[rows][..., None], [],
                                          use_ratio_loss=False, group=group)
        loss = bl + dl
        module.zero_grad()
        loss.backward()
        return {"loss": loss.detach(), "token_kl": bm["token_kl_loss"].detach(),
                "token_mse": dm["dyn_token_dist_loss"].detach()}

    ddp = torch.nn.parallel.DistributedDataParallel(copy.deepcopy(lin),
                                                    process_group=mesh.data_group)
    rows = local_rows(torch.arange(B), mesh)
    out = {}
    for key, group in (("global", mesh.data_group), ("local", None)):
        vals = global_batch_metrics(run(ddp, rows, group), mesh.data_group)
        out[key] = {"values": {k: float(v) for k, v in vals.items()},
                    "grads": [p.grad.clone() for p in ddp.module.parameters()]}
    if rank == 0:
        single = copy.deepcopy(lin)
        vals = run(single, torch.arange(B), None)
        out["single"] = {"values": {k: float(v) for k, v in vals.items()},
                         "grads": [p.grad.clone() for p in single.parameters()]}
    return out


def _accumulation(rank, mesh, weights):
    """Two micro-steps of k = 2 under DDP against one process's two on the
    global batches; the first micro-step's gradient stays the rank's own
    (no_sync)."""
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step
    from dense2sparse_vit_torch.train.train_step import wrap_ddp

    student, teacher = _port(weights)
    single = copy.deepcopy(student)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(grad_accum_steps=2, **TRAIN))
    batches = [(torch.from_numpy(_images(s)), torch.from_numpy(LABELS)) for s in (20, 21)]
    out = {}
    for model, key, wrap in ((student, "ddp", True), (single, "single", False)):
        if key == "single" and rank != 0:
            continue
        opt = make_optimizer(model, cfg.train, STEPS_PER_EPOCH)
        opt.count = EPOCH * STEPS_PER_EPOCH // 2
        step = make_train_step(wrap_ddp(model, cfg, mesh) if wrap else model, teacher, opt, cfg)
        first = None
        for i, (x, y) in enumerate(batches):
            if wrap:
                x, y = local_rows(x, mesh), local_rows(y, mesh)
            step(x, y, EPOCH)
            if i == 0:
                first = {n: p.grad.clone() for n, p in model.named_parameters()}
        out[key] = {"first_grads": first, "count": opt.count,
                    "last_grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                    "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                    "lrs": {g["label"]: g["lr"] for g in opt.param_groups}}
    return out


def _tensor_parallel(rank, tp_mesh, weights, tmp):
    """The student split over a model group of two against the replicated
    one: train-mode logits, the CLS rows gathered over the heads, every
    gradient (a split one against its slice of the full one); then the
    split state's checkpoint round trip."""
    from dense2sparse_vit_torch.parallel.tensor_parallel import _shard, gather_params, parallelize
    from dense2sparse_vit_torch.utils.checkpoint import (
        CheckpointManager,
        restore_tensor_parallel,
        save_tensor_parallel,
    )

    full, _ = _port(weights)
    tp = parallelize(copy.deepcopy(full), tp_mesh)
    x = torch.from_numpy(_images())
    r = torch.from_numpy(np.random.default_rng(41).standard_normal((B, 10)).astype(np.float32))
    got = {}
    for key, model in (("full", full), ("tp", tp)):
        model.train()
        o = model(x, collect_cls_attns=True)
        loss = (o.logits * r).sum() + sum(p.float().square().mean() for p in o.pred_logits)
        model.zero_grad()
        loss.backward()
        got[key] = {"logits": o.logits.detach(), "cls": [c.detach() for c in o.cls_attns],
                    "kept": [k.clone() for k in o.kept_idx],
                    "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    size, mr = tp_mesh.shape["model"], tp_mesh.model_rank
    got["full_grads_sliced"] = {n: _shard(n, g, mr, size) for n, g in got["full"]["grads"].items()}
    local = {k: v.detach().clone() for k, v in tp.state_dict().items()}
    got["gathered_is_full"] = all(
        torch.equal(v, full.state_dict()[k]) for k, v in gather_params(local, tp_mesh).items())
    ckpt = CheckpointManager(os.path.join(tmp, "tp_ckpt"))
    save_tensor_parallel(ckpt, 1, local, tp_mesh)
    restored = restore_tensor_parallel(ckpt, tp_mesh)
    got["roundtrip"] = restored.keys() == local.keys() and all(
        torch.equal(restored[k], v) for k, v in local.items())
    return got


def _checkpoint(rank, mesh, weights, tmp):
    """Rank 0 writes, every rank waits; rank 0 restores and broadcasts (the
    loop's resume), bit for bit."""
    from dense2sparse_vit_torch.train import make_optimizer
    from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager

    student, _ = _port(weights)
    opt = make_optimizer(student, TrainConfig(**TRAIN), STEPS_PER_EPOCH)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    state = {"student": {k: v.clone() for k, v in student.state_dict().items()},
             "optimizer": opt.state_dict(), "step": 3}
    ckpt.save(3, state)
    better = ckpt.save_if_best(3, state, 0.5)
    files = sorted(os.listdir(os.path.join(tmp, "ckpt", "latest")))
    got = [None]
    if rank == 0:
        got = [ckpt.restore(map_location="cpu")]
    dist.broadcast_object_list(got, src=0)
    same = all(torch.equal(got[0]["student"][k], v) for k, v in state["student"].items())
    from dense2sparse_vit_torch.parallel.tensor_parallel import replicate

    return {"files": files, "best": better, "bit_equal": same and got[0]["step"] == 3,
            "replicated": replicate({"r": torch.tensor([rank, 7])})["r"].tolist()}


def _hello(rank, mesh):
    from dense2sparse_vit_torch.experiments.spmd_hello_world import make_synthetic_data, train

    images, labels = make_synthetic_data()
    out = {"ddp": train(images, labels, mesh=mesh)[1]}
    if rank == 0:
        out["single"] = train(images, labels)[1]
    return out


def _rank_checks(rank, port, tmp, weights_path):
    _join(rank, port)
    weights = torch.load(weights_path, weights_only=False)
    mesh = make_mesh()
    out = {"topk": _train_step(rank, mesh, weights, bn=False),
           "bn": _train_step(rank, mesh, weights, bn=True),
           "denominators": _denominators(rank, mesh),
           "accumulation": _accumulation(rank, mesh, weights),
           "checkpoint": _checkpoint(rank, mesh, weights, tmp),
           "hello": _hello(rank, mesh)}
    out["tp"] = _tensor_parallel(rank, make_mesh(data=1, model=2), weights, tmp)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---- the JAX side and the fixtures -------------------------------------------


def _jax_variables(bn):
    import jax
    import jax.numpy as jnp

    from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
    from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
    from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
    from test_torch_ops import random_like_tree

    student = JaxStudent(cfg=JaxModelConfig(**MODEL),
                         pruning=JaxPruningConfig(**PRUNING, predictor_bn=bn))
    shapes = jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    out = {"params": random_like_tree(shapes["params"], seed=21)}
    if bn:  # flax's initial statistics: means 0, variances 1
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, s: np.full(s.shape, 0.0 if p[-1].key == "mean" else 1.0, np.float32),
            shapes["batch_stats"])
    return out


def _jax_teacher_params():
    import jax
    import jax.numpy as jnp

    from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
    from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
    from test_torch_ops import random_like_tree

    shapes = jax.eval_shape(JaxTeacher(cfg=JaxModelConfig(**MODEL)).init,
                            jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    return random_like_tree(shapes["params"], seed=22)


def _jax_step(bn):
    """(metrics, gradients, updated parameters, batch statistics) of the JAX
    train step on the global batch, its optimizer's update applied to the
    gradients it takes (test_torch_train_step._jax_step)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
    from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
    from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
    from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
    from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
    from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
    from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from dense2sparse_vit_tpu.train.train_step import TrainState
    from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step
    from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
    from test_torch_train_step import _grad_probe, _set_schedule_count

    cfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL),
                              pruning=JaxPruningConfig(**PRUNING, predictor_bn=bn),
                              train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    variables = _jax_variables(bn)
    params = variables["params"]
    tx = jax_make_optimizer(cfg.train, STEPS_PER_EPOCH)
    opt_state = _set_schedule_count(tx.init(params), EPOCH * STEPS_PER_EPOCH)
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables.get("batch_stats", {}),
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, JaxTeacher(cfg=cfg.model), probe, cfg))
    probed, metrics = step(state, _jax_teacher_params(), jnp.asarray(_images()),
                           jnp.asarray(LABELS), jax.random.PRNGKey(3), jnp.float32(EPOCH))
    updates, _ = tx.update(probed.opt_state, opt_state, params)
    stats = {k: v for k, v in state_dict_from_jax(
        {"params": params, "batch_stats": probed.batch_stats}).items() if "running" in k}
    return ({k: float(v) for k, v in metrics.items()}, state_dict_from_jax(probed.opt_state),
            state_dict_from_jax(optax.apply_updates(params, updates)), stats)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of `_rank_checks` (two gloo ranks, one spawn)."""
    from dense2sparse_vit_torch.utils.convert import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("ranks"))
    weights = {"student": state_dict_from_jax(_jax_variables(False)),
               "bn": state_dict_from_jax(_jax_variables(True)),
               "teacher": state_dict_from_jax(_jax_teacher_params())}
    path = os.path.join(tmp, "weights.pt")
    torch.save(weights, path)
    _spawn(_rank_checks, WORLD, free_port(), tmp, path)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def _check_against_one_process(ranks, kind, grad_tol=1e-5):
    """The DDP step against one process's on the global batch: metrics
    within rtol 1e-5; every averaged gradient within `grad_tol` of its
    tensor's largest magnitude (fp32 reduction order), the SHIFT_INVARIANT
    biases' (rounding noise on both sides) within 1e-4 of a floor of 1e-3
    of the model's largest gradient, as test_torch_train_step holds them;
    the updated parameters as `_check_params` holds them."""
    ddp, single = ranks[0][kind]["ddp"], ranks[0][kind]["single"]
    for k, v in single["metrics"].items():
        _close(ddp["metrics"][k], v, atol=0.0, rtol=1e-5, msg=k)
    floor = 1e-3 * max(g.abs().max() for g in single["grads"].values())
    for n, g in single["grads"].items():
        tol = 1e-4 if n.endswith(SHIFT_INVARIANT) else grad_tol
        _close(ddp["grads"][n], g, atol=tol * max(g.abs().max(), floor), msg=n)
    _check_params([r[kind]["ddp"]["params"] for r in ranks], single["params"], single["grads"],
                  single["lrs"])
    return ddp


def _check_params(ddp, single, grads, lrs):
    """Updated parameters within 1e-6 of one process's where the gradient's
    sign is sure (above 1e-3 of its tensor's largest magnitude), and within
    one Adam step elsewhere: a first Adam step moves a parameter by about
    lr * sign(g), and where g is rounding noise (the key bias, the
    predictor's shift-invariant biases) so is its sign. Every rank's
    parameters bit-equal."""
    floor = 1e-3 * max(g.abs().max() for g in grads.values())
    lr = max(lrs.values())
    for n, p in single.items():
        g = grads[n]
        sure = g.abs() > 1e-3 * max(g.abs().max(), floor)
        _close(ddp[0][n][sure], p[sure], atol=1e-6, msg=n)
        bound = 2 * 1.01 * lr * (1 + TrainConfig().weight_decay * p.abs()) + 1e-7
        assert ((ddp[0][n] - p).abs() <= bound).all(), n
        for other in ddp[1:]:
            assert torch.equal(other[n], ddp[0][n]), n


def _check_against_jax(ddp, want, stats_tol):
    """test_torch_train_step's rules: metrics within 1e-5, every gradient
    within 1e-4 of its tensor's largest magnitude (the BatchNorm
    predictor's 1e-3: its gradients carry the JAX layer's one-pass batch
    variance, test_torch_student_modes), updated parameters within
    1e-2 * lr where the gradient's sign is sure, and within one Adam step
    elsewhere."""
    metrics, grads, new_params, stats = want
    assert set(metrics) == set(ddp["metrics"])
    for k, v in metrics.items():
        _close(ddp["metrics"][k], v, rtol=1e-5, atol=1e-5, msg=k)
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    for name, g in grads.items():
        if name not in ddp["grads"]:
            continue
        scale = max(np.abs(g).max(), floor)
        tol = 1e-3 if ".bn." in name or ("score_predictor" in name and stats) else 1e-4
        if not name.endswith(SHIFT_INVARIANT):
            _close(ddp["grads"][name], g, atol=tol * scale, msg=name)
        new = ddp["params"][name].numpy()
        sure = np.abs(g) > 1e-3 * scale
        lr = max(ddp["lrs"].values())
        if not name.endswith(SHIFT_INVARIANT) and tol < 1e-3:
            _close(new[sure], new_params[name][sure], atol=1e-2 * lr + 1e-12, msg=name)
    for name, v in stats.items():
        _close(ddp["stats"][name], v, atol=stats_tol, rtol=stats_tol, msg=name)


def test_a_two_rank_topk_step_is_the_one_process_step_on_the_global_batch(ranks):
    """`_check_against_one_process`: metrics within rtol 1e-5, gradients
    within 1e-5, updated parameters within 1e-6 (where sure)."""
    _check_against_one_process(ranks, "topk")


def test_a_two_rank_topk_step_matches_jax_on_the_global_batch(ranks):
    _check_against_jax(ranks[0]["topk"]["ddp"], _jax_step(False), 0.0)


def test_the_batchnorm_predictor_takes_global_statistics(ranks):
    """The BatchNorm predictor's step on two ranks: loss, gradients,
    parameters and running statistics those of one process on the global
    batch (`_check_against_one_process` with the gradients within 1e-4 and
    the statistics within 1e-6: the global moments are E[x^2] - E[x]^2 of
    all-reduced sums, torch's one process takes two passes), and the JAX
    step's (batch_stats within 1e-5)."""
    ddp = _check_against_one_process(ranks, "bn", grad_tol=1e-4)
    single = ranks[0]["bn"]["single"]
    assert ddp["stats"] and ddp["stats"].keys() == single["stats"].keys()
    for n, v in single["stats"].items():
        _close(ddp["stats"][n], v, atol=1e-6, rtol=1e-6, msg=n)
        assert torch.equal(ranks[1]["bn"]["ddp"]["stats"][n], ddp["stats"][n]), n
    _check_against_jax(ddp, _jax_step(True), 1e-5)


def test_both_token_denominators_are_global(ranks):
    """With 11 kept tokens on rank 0 and 3 on rank 1, the mean of the ranks'
    losses and the averaged gradient equal the global batch's (1e-6);
    without the group they do not."""
    got = ranks[0]["denominators"]
    for key in ("loss", "token_kl", "token_mse"):
        _close(got["global"]["values"][key], got["single"]["values"][key], atol=1e-6, msg=key)
    for g, w in zip(got["global"]["grads"], got["single"]["grads"]):
        _close(g, w, atol=1e-6)
    assert abs(got["local"]["values"]["token_mse"] - got["single"]["values"]["token_mse"]) > 1e-3
    assert max((g - w).abs().max() for g, w in zip(got["local"]["grads"],
                                                   got["single"]["grads"])) > 1e-4


def test_two_accumulation_micro_steps_match_one_process(ranks):
    """k = 2 on two ranks: the first micro-step runs under no_sync (each
    rank's gradient its own), and the update after the second is one
    process's on the same two global batches (`_check_params`, the mean of
    the micro-steps' gradients telling which signs are sure), which
    tests/test_torch_loop.py holds to JAX's MultiSteps."""
    a, b = ranks[0]["accumulation"]["ddp"], ranks[1]["accumulation"]["ddp"]
    single = ranks[0]["accumulation"]["single"]
    assert a["count"] == single["count"] == EPOCH * STEPS_PER_EPOCH // 2 + 1
    assert any(not torch.equal(a["first_grads"][n], b["first_grads"][n]) for n in a["first_grads"])
    mean = {n: (g + single["last_grads"][n]) / 2 for n, g in single["first_grads"].items()}
    _check_params([a["params"], b["params"]], single["params"], mean, single["lrs"])


def test_tensor_parallel_forward_and_backward_match_the_replicated_student(ranks):
    """model = 2: logits and CLS rows within rtol 1e-4 / atol 1e-5 of the
    replicated student's (the same kept tokens), every replicated
    parameter's gradient equal to the full one's and every split one equal
    to its slice of the full one, at the same tolerance (JAX
    `test_tp_forward_matches_replicated`)."""
    for r in ranks:
        tp = r["tp"]
        _close(tp["tp"]["logits"], tp["full"]["logits"], atol=1e-5, rtol=1e-4)
        assert len(tp["tp"]["cls"]) == len(tp["full"]["cls"]) == MODEL["depth"]
        for c, w in zip(tp["tp"]["cls"], tp["full"]["cls"]):
            _close(c, w, atol=1e-5, rtol=1e-4)
        for k, w in zip(tp["tp"]["kept"], tp["full"]["kept"]):
            assert torch.equal(k, w)
        assert tp["tp"]["grads"].keys() == tp["full_grads_sliced"].keys()
        for n, g in tp["tp"]["grads"].items():
            want = tp["full_grads_sliced"][n]
            assert g.shape == want.shape, n
            _close(g, want, atol=1e-5, rtol=1e-4, msg=n)
    qkv = "blocks.0.attn.qkv.weight"
    assert ranks[0]["tp"]["tp"]["grads"][qkv].shape[0] == 3 * MODEL["embed_dim"] // 2


def test_checkpoints_write_once_and_round_trip_bit_identically(ranks):
    """Rank 0 alone writes (one file pair seen by both ranks), both ranks
    agree on the best, the broadcast restore is bit-equal, `replicate`
    gives every rank rank 0's tensors, and the
    tensor-parallel state gathers to the full student and restores into
    its shards bit for bit."""
    for r in ranks:
        assert r["checkpoint"]["files"] == ["step_3.json", "step_3.pt"]
        assert r["checkpoint"]["best"] is True and r["checkpoint"]["bit_equal"]
        assert r["checkpoint"]["replicated"] == [0, 7]  # rank 0's copy everywhere
        assert r["tp"]["gathered_is_full"] and r["tp"]["roundtrip"]


def test_spmd_hello_world_two_ranks_match_one_process(ranks):
    got = ranks[0]["hello"]
    assert abs(got["ddp"] - got["single"]) < 1e-3
    assert ranks[1]["hello"]["ddp"] == got["ddp"]


# ---- run_experiment through the CLI on two ranks -----------------------------


def _argv(folder, workdir, epochs, port, rank):
    return ["--imgnet-val-dir", folder, "--img-size", "32", "--eval-crop", "32",
            "--eval-resize", "36", "--patch-size", "8", "--num-classes", "10",
            "--arch", "deit_tiny", "--pruning-locs", "0", "1", "--keep-ratios", "0.7", "0.49",
            "--small-predictor", "--batch-size", "8", "--warmup-steps", "1", "--seed", "0",
            "--epochs", str(epochs), "--workdir", workdir, "--device", "cpu",
            "--dist-coordinator", f"127.0.0.1:{port}", "--dist-num-processes", str(WORLD),
            "--dist-process-id", str(rank)]


def _rank_loop(rank, ports, folder, workdir, out):
    """Two CLI runs on this rank: one epoch, then a second with --resume;
    what the rank logged (its val metrics, its summed eval counts) and each
    run's summary."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # the logger skips TensorBoard
    import dense2sparse_vit_torch.train.loop as loop
    from dense2sparse_vit_torch import cli

    seen = {"val": [], "sums": [], "starts": []}

    def record(self, metrics, step, prefix=""):
        if prefix == "val":
            seen["val"].append(dict(metrics))
        return log(self, metrics, step, prefix)

    log = loop.MetricsLogger.log if rank == 0 else loop._NullLogger.log
    (loop.MetricsLogger if rank == 0 else loop._NullLogger).log = record
    sums = loop.all_reduce_sums

    def recording_sums(tree, group=None):
        got = sums(tree, group)
        if "n_valid" in tree:
            seen["sums"].append((float(tree["n_valid"]), float(got["n_valid"])))
        return got

    loop.all_reduce_sums = recording_sums
    make = loop.make_train_step

    def counting(*a, **k):
        step = make(*a, **k)
        opt = a[2]
        seen["starts"].append(opt.count)
        return step

    loop.make_train_step = counting
    summaries = [cli.main(_argv(folder, workdir, 1, ports[0], rank)),
                 cli.main(_argv(folder, workdir, 2, ports[1], rank) + ["--resume"])]
    torch.save({"seen": seen, "summaries": summaries}, os.path.join(out, f"loop{rank}.pt"))


@pytest.fixture(scope="module")
def loop_ranks(tmp_path_factory):
    from test_torch_data import write_folder

    folder = str(tmp_path_factory.mktemp("dist_images"))
    write_folder(folder, classes=5, images=10)
    workdir = str(tmp_path_factory.mktemp("dist_run"))
    out = str(tmp_path_factory.mktemp("dist_out"))
    _spawn(_rank_loop, WORLD, (free_port(), free_port()), folder, workdir, out)
    return workdir, [torch.load(os.path.join(out, f"loop{r}.pt"), weights_only=False)
                     for r in range(WORLD)]


def test_run_experiment_on_two_ranks_covers_val_once_and_logs_the_same(loop_ranks):
    """Both ranks' val metrics are the same, and the eval's summed count is
    every val image once (10 of 50: 5 a rank, a batch of 4 and a padded
    one), at both evals (one a run)."""
    from dense2sparse_vit_torch.data import split_train_val_indices

    _, got = loop_ranks
    n_val = len(split_train_val_indices(50, 0.8, seed=0)[1])
    assert n_val == 10
    for r in got:
        assert [t for _, t in r["seen"]["sums"]] == [n_val] * 2
        assert [n for n, _ in r["seen"]["sums"]] == [n_val / WORLD] * 2
    assert len(got[0]["seen"]["val"]) == 2
    assert got[0]["seen"]["val"] == got[1]["seen"]["val"]
    assert got[0]["summaries"] == got[1]["summaries"]


def test_run_experiment_on_two_ranks_writes_once_and_resumes(loop_ranks):
    """metrics.jsonl holds each record once and the checkpoint stream one
    file a save; the --resume run starts at the first run's step count
    (5 steps of 4 samples a rank an epoch) and ends at twice it."""
    workdir, got = loop_ranks
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    keys = [json.dumps(r, sort_keys=True) for r in records]
    assert len(keys) == len(set(keys))
    assert sum(1 for r in records if "val/val_acc" in r) == 2
    latest = sorted(os.listdir(os.path.join(workdir, "ckpt", "latest")))
    assert latest == ["step_10.json", "step_10.pt", "step_5.json", "step_5.pt"]
    for r in got:
        assert r["seen"]["starts"] == [0, 5]
        assert r["summaries"][1]["epochs"] == 2


# ---- the four-rank dry run ------------------------------------------------------


def test_the_four_rank_dry_run_passes():
    """`scripts/dryrun_multichip.py` on a 2 x 2 gloo mesh: the tensor-parallel
    top-k, cached-teacher and gumbel steps, the eval and the split
    checkpoint's bit-identical round trip; about 10 s here."""
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-m", "dense2sparse_vit_torch.scripts.dryrun_multichip",
                          "--nprocs", "4", "--device", "cpu"], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip OK: 4 processes, mesh {'data': 2, 'model': 2}" in res.stdout
