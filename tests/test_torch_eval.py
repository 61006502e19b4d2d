"""Port parity of the eval steps: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

`make_eval_step` (top-k and threshold, plain, and fused with int8 blocks:
in threshold mode its policy blocks are the fused fp32 ones) and `make_dynamic_vit_eval_step` against the JAX package's, on the
tiny widths of `test_torch_train.py`, the same weights and one batch whose
last two rows are padding (label -1). fp32 on the CPU; every metric within
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.models.dynamic_vit_default as jax_dvd
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.train.train_step import (
    make_dynamic_vit_eval_step as jax_make_dynamic_vit_eval_step,
)
from dense2sparse_vit_tpu.train.train_step import make_eval_step as jax_make_eval_step

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, PruningConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.train import make_dynamic_vit_eval_step, make_eval_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_dynamic_vit import DPRUNING, STUDENT as GUMBEL_STUDENT
from test_torch_dynamic_vit import _student_params as _gumbel_params
from test_torch_ops import load_numpy_state
from test_torch_quant import _jax_interpret
from test_torch_train import MODEL, PRUNING, _student_params, _teacher_params

TEACHER = "dynamic_vit_small_patch16_224_teacher"
STUDENT = "dynamic_vit_small_patch16_224_student"


def _images():
    return np.random.default_rng(60).standard_normal((4, 32, 32, 3)).astype(np.float32)


def _with_jax_interpret(fn):
    saved = [(m, n, getattr(m, n)) for m, n, _ in _jax_interpret()]
    try:
        for m, n, patched in _jax_interpret():
            setattr(m, n, patched)
        return fn()
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)


def _labels(student, teacher):
    """Row 0 labelled with the teacher's top-1, row 1 with the student's
    (so that neither accuracy is trivially 0), rows 2-3 padding."""
    x = torch.from_numpy(_images())
    with torch.no_grad():
        s_top1 = int(student.eval()(x).logits[1].argmax())
        t_top1 = int(teacher(x)[0][0].argmax())
    return np.array([t_top1, s_top1, -1, -1])


def _teacher(fused):
    teacher = create_model(TEACHER, device="cpu", use_fused_attention=fused, **MODEL)
    return load_numpy_state(teacher, state_dict_from_jax(_teacher_params()))


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _jax_eval(threshold, fused, quant, labels):
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(use_fused_attention=fused, quant=quant, **MODEL),
        pruning=JaxPruningConfig(patch_score_threshold=threshold, **PRUNING))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=JaxModelConfig(use_fused_attention=fused, **MODEL))
    step = jax.jit(jax_make_eval_step(student, teacher, cfg))
    return _with_jax_interpret(lambda: step(_student_params(), {}, _teacher_params(),
                                            jnp.asarray(_images()), jnp.asarray(labels)))


@pytest.mark.parametrize("threshold,fused,quant", [
    (None, False, "none"), (0.5, False, "none"), (None, True, "int8"), (0.5, True, "int8"),
])
def test_eval_step_matches_jax(threshold, fused, quant):
    student = create_model(STUDENT, device="cpu", use_fused_attention=fused, quant=quant,
                           patch_score_threshold=threshold, **MODEL, **PRUNING)
    load_numpy_state(student, state_dict_from_jax(_student_params()))
    teacher = _teacher(fused)
    labels = _labels(student, teacher)
    want = _jax_eval(threshold, fused, quant, labels)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning)
    step = make_eval_step(student, teacher, cfg)
    ops.reset_launch_counts()
    got = step(torch.from_numpy(_images()), torch.from_numpy(labels))
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU tensors
    assert got["n_valid"].item() == 2
    assert (threshold is not None) == ("avg_keep_ratio" in got)
    _assert_metrics(got, want)


def test_dynamic_vit_eval_step_matches_jax():
    cfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**DPRUNING))
    student = jax_dvd.DynamicViTStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    port = create_model(GUMBEL_STUDENT, device="cpu", **MODEL, **DPRUNING)
    load_numpy_state(port, state_dict_from_jax(_gumbel_params()))
    port_teacher = _teacher(False)
    labels = _labels(port, port_teacher)
    want = jax.jit(jax_make_dynamic_vit_eval_step(student, teacher, cfg))(
        _gumbel_params(), {}, _teacher_params(), jnp.asarray(_images()), jnp.asarray(labels))
    step = make_dynamic_vit_eval_step(port, port_teacher,
                                      ExperimentConfig(model=port.cfg, pruning=port.pruning))
    got = step(torch.from_numpy(_images()), torch.from_numpy(labels))
    assert got["n_valid"].item() == 2 and got["val_acc"].item() > 0
    _assert_metrics(got, want)


def test_eval_step_masks_every_padded_row():
    """Relabelling the padding rows changes no metric."""
    student = create_model(STUDENT, device="cpu", **MODEL, **PRUNING)
    step = make_eval_step(student, _teacher(False),
                          ExperimentConfig(model=student.cfg, pruning=student.pruning))
    x = torch.from_numpy(_images())
    a = step(x, torch.tensor([1, 2, -1, -1]))
    b = step(x, torch.tensor([1, 2, -1, -7]))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(TypeError, match="float"):
        step(x.to(torch.uint8), torch.tensor([1, 2, -1, -1]))


@pytest.mark.parametrize("field,value", [
    ("selection", "random"), ("cls_from_teacher", True), ("predictor_bn", True)])
def test_eval_step_rejects_unported_options(field, value):
    student = create_model(STUDENT, device="cpu", **MODEL, **PRUNING)
    cfg = ExperimentConfig(model=student.cfg, pruning=PruningConfig(**PRUNING, **{field: value}))
    with pytest.raises(NotImplementedError, match=field):
        make_eval_step(student, student, cfg)
