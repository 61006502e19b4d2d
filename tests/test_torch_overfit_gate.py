"""The port's overfit-one-batch gate (`dense2sparse_vit_torch/scripts/
overfit_gate.py`) against the JAX package's (`scripts/overfit_gate.py`).

On the CPU, at a tiny size: the gate's verdict on hand-made loss curves
(JAX's thresholds, a mask accuracy that falls), the script's one JSON line
with the JAX gate's keys from a few steps of a depth-2 student, and the
trajectory the gate's configuration drives: five steps of JAX's
`make_train_step` and of the port's, with the gate's AdamW (warmup 0,
10_000 epochs, the backbone at the full lr), on one set of weights carried
across by `utils.convert` and one batch, the losses within 1e-4 of their
size at every step (fp32; the updates' roundings compound over the steps).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.scripts import overfit_gate
from dense2sparse_vit_torch.train import make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import load_numpy_state, random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10)
TINY_PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.7,))
GATE_TRAIN = dict(epochs=10_000, warmup_epochs=0, backbone_lr_scale=1.0)


def _jax_gate_keys() -> list:
    """The keys of the JSON object the JAX gate prints, read from its
    source (the script runs JAX on import of its main, not at import)."""
    tree = ast.parse((REPO / "scripts" / "overfit_gate.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict in scripts/overfit_gate.py")


@pytest.mark.parametrize("curves,ok", [
    # cross-entropy 10x, loss 5x, mask accuracy up to 0.95: passes
    (([5.0, 1.0], [2.0, 0.2], [0.5, 0.95]), True),
    # exactly at the thresholds: 8x, 4x, 0.9
    (([4.0, 1.0], [8.0, 1.0], [0.9, 0.9]), True),
    # cross-entropy only 7.9x
    (([5.0, 1.0], [7.9, 1.0], [0.5, 0.95]), False),
    # the loss only 3.9x
    (([3.9, 1.0], [8.0, 1.0], [0.5, 0.95]), False),
    # mask accuracy below 0.9
    (([5.0, 1.0], [2.0, 0.2], [0.5, 0.89]), False),
    # mask accuracy above 0.9 but fallen from the first step
    (([5.0, 1.0], [2.0, 0.2], [0.97, 0.93]), False),
])
def test_the_gate_holds_jax_thresholds(curves, ok):
    got = overfit_gate.gate(*curves)
    assert got["pass"] is ok
    assert list(got) == _jax_gate_keys()
    assert got["steps"] == 2 and got["gate"] == "overfit_one_batch"


def test_a_tiny_run_prints_one_line_with_jax_keys(monkeypatch, capsys):
    """The script's main on the CPU, its run shrunk to a depth-2 student at
    32 px, B=4, three steps: one parseable JSON line, the JAX gate's keys,
    finite losses; the exit code follows the verdict."""
    run = overfit_gate.run
    monkeypatch.setattr(overfit_gate, "run", lambda device, steps: run(
        device, steps=steps, batch=4, overrides=TINY, pruning=TINY_PRUNING))
    rc = overfit_gate.main(["--device", "cpu", "--steps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == _jax_gate_keys() and got["steps"] == 3
    assert all(np.isfinite(got[k]) for k in ("first_loss", "last_loss", "first_cls_loss"))
    assert rc == (0 if got["pass"] else 1)


STEPS = 5
B = 4


def _images():
    return np.random.default_rng(71).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels():
    return np.array([1, 4, 7, 9])


def test_five_gate_steps_match_jax():
    """Five steps of the gate's configuration on one batch: the loss, the
    cross-entropy and the mask accuracy of every step within 1e-4 of their
    size (the accuracy exact), JAX's `make_train_step` with its AdamW
    against the port's, one set of weights."""
    cfg = JaxExperimentConfig(model=JaxModelConfig(**TINY),
                              pruning=JaxPruningConfig(**TINY_PRUNING),
                              train=JaxTrainConfig(batch_size=B, **GATE_TRAIN))
    student, teacher = JaxStudent(cfg=cfg.model, pruning=cfg.pruning), JaxTeacher(cfg=cfg.model)
    imgs = jnp.asarray(_images())
    s = jax.eval_shape(student.init, jax.random.PRNGKey(0), imgs[:1])
    t = jax.eval_shape(teacher.init, jax.random.PRNGKey(1), imgs[:1])
    params = random_like_tree(s["params"], seed=72)
    t_params = random_like_tree(t["params"], seed=73)
    tx = jax_make_optimizer(cfg.train, 1)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, tx, cfg))
    want = []
    for i in range(STEPS):
        state, m = step(state, t_params, imgs, jnp.asarray(_labels()),
                        jax.random.fold_in(jax.random.PRNGKey(4), i), jnp.float32(0.0))
        want.append([float(m["loss"]), float(m["cls_loss"]), float(m["mask_acc_0"])])

    kw = dict(device="cpu", **TINY)
    port = load_numpy_state(
        create_model("dynamic_vit_small_patch16_224_student", **kw, **TINY_PRUNING),
        state_dict_from_jax(params))
    port_teacher = load_numpy_state(create_model("dynamic_vit_small_patch16_224_teacher", **kw),
                                    state_dict_from_jax(t_params))
    pcfg = ExperimentConfig(model=port.cfg, pruning=port.pruning,
                            train=TrainConfig(batch_size=B, **GATE_TRAIN))
    pstep = make_train_step(port, port_teacher, make_optimizer(port, pcfg.train, 1), pcfg)
    x, y = torch.from_numpy(_images()), torch.from_numpy(_labels())
    got = []
    for i in range(STEPS):
        m = pstep(x, y, 0.0, generator=torch.Generator().manual_seed(4 + i))
        got.append([m["loss"].item(), m["cls_loss"].item(), m["mask_acc_0"].item()])
    got, want = np.asarray(got), np.asarray(want)
    assert want[-1, 0] < want[0, 0]  # the steps train
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-4, atol=0)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
