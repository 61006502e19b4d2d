"""Port parity of training with the student's own CLS-attention capture:
dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The packed attention both ways (plain and policy mode, with and without the
CLS rows' cotangent), the MLP half both ways, a training Block that captures
its CLS rows, the attn-selection student's eval and train forwards (and
CLS capture on a top-k and a threshold student) and one train step of the
attn student, at a small size: 32 px images, patch 8 (N = 17), depth 4 with
stages at blocks 1 and 2, C = 128, 2 heads (the kernels' head_dim 64),
fp32 on the CPU. The same inputs, drawn with numpy from fixed seeds, go
through the JAX function (its Pallas kernels in interpret mode) and the
port's counterpart, which runs its plain torch version for CPU tensors.
Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
import dense2sparse_vit_tpu.ops.pallas.mlp as jax_mlp
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.nn.layers import Block as JaxBlock
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step
from dense2sparse_vit_tpu.utils.convert import (
    convert_student_state_dict,
    export_student_state_dict,
)

import dense2sparse_vit_torch.nn.layers as port_layers
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.ops.attention import (
    fused_attention_backward_packed,
    fused_attention_packed,
)
from dense2sparse_vit_torch.ops.mlp import fused_mlp_residual, fused_mlp_residual_backward
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, _port_block_state, load_numpy_state, random_like_tree
from test_torch_train import _flax_block_params, _with_interpret
from test_torch_train_step import _grad_probe
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL = dict(img_size=32, patch_size=8, embed_dim=128, depth=4, num_heads=2, num_classes=10)
ATTN = dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), selection="attn")
B, C, H = 2, 128, 2
TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH = 3
STUDENT = "dynamic_vit_small_patch16_224_student"
TEACHER = "dynamic_vit_small_patch16_224_teacher"


def _rng(seed):
    return np.random.default_rng(seed)


def _qkv(n, seed=40):
    return _rng(seed).standard_normal((B, n, 3 * C)).astype(np.float32)


def _keep_policy(n, seed=41):
    pol = (_rng(seed).random((B, n)) < 0.6).astype(np.float32)
    pol[:, 0] = 1.0
    return pol


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---- the packed attention --------------------------------------------------


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("n", [13, 17])
def test_packed_forward_matches_pallas(n, policy):
    """Output and CLS rows within 1e-5 (fp32; the TPU kernel pads N to 16
    and sums in another order)."""
    qkv = _qkv(n)
    pol = _keep_policy(n) if policy else None
    want_out, want_cls = jax_attention.fused_attention_packed(
        _j(qkv), H, _j(pol), exact=True, return_cls=True, interpret=True)
    out, cls = fused_attention_packed(_t(qkv), H, _t(pol), return_cls=True)
    assert cls.shape == (B, H, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cls.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("with_gcls", [False, True])
@pytest.mark.parametrize("policy", [False, True])
def test_packed_backward_matches_pallas(policy, with_gcls):
    """dqkv, and dPolicy in policy mode, from g and the CLS rows' cotangent
    gcls: within 1e-4 of each tensor's largest magnitude (fp32 sums in
    another order)."""
    n = 17
    rng = _rng(42)
    qkv = _qkv(n)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    gcls = rng.standard_normal((B, H, n)).astype(np.float32) if with_gcls else None
    pol = _keep_policy(n) if policy else None
    want = jax_attention.fused_attention_backward_packed(
        _j(qkv), _j(g), H, policy=_j(pol), gcls=_j(gcls), interpret=True)
    got = fused_attention_backward_packed(_t(qkv), _t(g), H, policy=_t(pol), gcls=_t(gcls))
    pairs = zip(got, want) if policy else [(got, want)]
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_cls_cotangent_reaches_the_scores():
    """The fold is no no-op: gcls alone (g = 0) moves dQ and dK, and a gcls
    constant along each row (which the softmax's row sum cancels) gives no
    gradient."""
    qkv = _t(_qkv(17))
    g = torch.zeros((B, 17, C))
    gcls = torch.from_numpy(_rng(43).standard_normal((B, H, 17)).astype(np.float32))
    assert fused_attention_backward_packed(qkv, g, H, gcls=gcls)[..., :2 * C].abs().max() > 1e-3
    const = fused_attention_backward_packed(qkv, g, H, gcls=torch.ones((B, H, 17)))
    assert const.abs().max() < 1e-5


# ---- the MLP half -------------------------------------------------------------


def _mlp_case(n=17, seed=44):
    p = _block_params(C, 4 * C, seed)
    rng = _rng(seed + 1)
    x = rng.standard_normal((B, n, C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    jw = [p[k] for k in ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")]
    # the port's Linear layout (out, in)
    tw = [w.T.copy() if w.ndim == 2 else w for w in jw]
    return x, g, jw, tw


def test_mlp_forward_and_backward_match_pallas():
    """Output within 1e-5; dx and the six gradients (w1/w2 against the JAX
    (in, out) layout transposed) within 1e-4 of each one's largest
    magnitude."""
    x, g, jw, tw = _mlp_case()
    want = jax_mlp.fused_mlp_residual(_j(x), *map(_j, jw), 1e-6, 8, True)
    got = fused_mlp_residual(_t(x), *map(_t, tw), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jax_mlp.fused_mlp_residual_backward(_j(x), _j(g), *map(_j, jw[:5]), interpret=True)
    got = fused_mlp_residual_backward(_t(x), _t(g), *map(_t, tw[:5]))
    for name, a, b in zip(("dx", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), got, want):
        b = np.asarray(b)
        b = b.T if b.ndim == 2 and name.startswith("w") else b
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_mlp_function_gradients_are_its_backward():
    x, g, _, tw = _mlp_case(n=13, seed=46)
    xs = [_t(x).requires_grad_()] + [_t(w).requires_grad_() for w in tw]
    fused_mlp_residual(*xs, 1e-6).backward(_t(g))
    want = fused_mlp_residual_backward(_t(x), _t(g), *map(_t, tw[:5]))
    for a, b in zip(xs, want):
        torch.testing.assert_close(a.grad, b, rtol=0, atol=0)


# ---- a training Block that captures its CLS rows ---------------------------


def test_train_block_with_cls_capture_matches_jax_block():
    """The fused JAX Block in train mode (deterministic=False) with
    return_cls_attn, under jax.vjp with the Pallas kernels in interpret
    mode, against the port's: output and CLS rows within 1e-5, dx and every
    parameter gradient within 1e-4 of its largest magnitude, from the
    cotangents of both outputs."""
    p = _block_params(C, 4 * C, seed=47)
    rng = _rng(48)
    x = rng.standard_normal((B, 17, C)).astype(np.float32)
    g = rng.standard_normal((B, 17, C)).astype(np.float32)
    gcls = rng.standard_normal((B, H, 17)).astype(np.float32)
    blk = JaxBlock(num_heads=H, use_fused=True)

    def fwd(xx, prm):
        return blk.apply({"params": prm}, xx, return_cls_attn=True, deterministic=False)

    def run():
        (out, cls), vjp = jax.vjp(fwd, jnp.asarray(x), _flax_block_params(
            {k: jnp.asarray(v) for k, v in p.items()}))
        return out, cls, vjp((jnp.asarray(g), jnp.asarray(gcls)))

    want_out, want_cls, (want_dx, want_dp) = _with_interpret(run)
    port = load_numpy_state(Block(C, H, use_fused=True), _port_block_state(p)).train()
    xt = torch.from_numpy(x).requires_grad_()
    out, cls = port(xt, return_cls_attn=True)
    torch.autograd.backward([out, cls], [_t(g), _t(gcls)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(want_cls), rtol=1e-5, atol=1e-6)
    want_grads = state_dict_from_jax({"blocks_0": want_dp})
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_dx)).max())
    for name, prm in port.named_parameters():
        want = want_grads[f"blocks.0.{name}"]
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


# ---- the students ----------------------------------------------------------


def _images(seed=49):
    return _rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _params(kind):
    """Seeded params of the attn, top-k or threshold student, or the teacher."""
    if kind == "teacher":
        module = JaxTeacher(cfg=JaxModelConfig(**MODEL))
    else:
        module = JaxStudent(cfg=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**_KINDS[kind]))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=50 + len(kind))


_KINDS = {
    "attn": ATTN,
    "topk": dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True),
    "threshold": dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True,
                      patch_score_threshold=0.5),
}


def _port_student(kind, use_fused):
    model = create_model(STUDENT, device="cpu", use_fused_attention=use_fused, **MODEL,
                         **_KINDS[kind])
    return load_numpy_state(model, state_dict_from_jax(_params(kind)))


@functools.lru_cache(maxsize=None)
def _jax_forward(kind, deterministic, fused):
    student = JaxStudent(cfg=JaxModelConfig(use_fused_attention=fused, **MODEL),
                         pruning=JaxPruningConfig(**_KINDS[kind]))
    run = jax.jit(lambda p, x: student.apply({"params": p}, x, deterministic=deterministic,
                                             collect_cls_attns=True))
    return _with_interpret(lambda: run(_params(kind), jnp.asarray(_images())))


@pytest.mark.parametrize("kind,port_fused,train", [
    ("attn", True, False), ("attn", True, True), ("attn", False, False), ("attn", False, True),
    ("topk", True, True), ("threshold", True, True)])
def test_student_with_cls_capture_matches_jax(kind, port_fused, train):
    """Eval and train mode, CLS rows captured (always in attn mode): logits,
    features and pred_logits within 1e-4, kept indices exact, the per-block
    CLS rows over the spatial tokens within 1e-5, their widths shrinking at
    the stages (threshold mode: only the block before the first stage
    captures). The attn student against the fused JAX model (Pallas in
    interpret mode); the top-k and threshold students, whose train-mode
    capture takes the same route, against the flax one."""
    want = _jax_forward(kind, not train, kind == "attn")
    model = _port_student(kind, port_fused).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(_images()))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **tol)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **tol)
    assert len(got.pred_logits) == len(want.pred_logits) == 2
    for a, b in zip(got.pred_logits, want.pred_logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for a, b in zip(got.kept_idx, want.kept_idx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    widths = {"attn": [16, 11, 7, 7], "topk": [16, 11, 7, 7], "threshold": [16]}[kind]
    assert [t.shape[-1] for t in got.cls_attns] == widths
    assert len(want.cls_attns) == len(widths)
    for a, b in zip(got.cls_attns, want.cls_attns):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_attn_student_has_no_predictor_and_maps_to_jax_params():
    """No predictor keys; the weights map both ways bit for bit: the port's
    map against the JAX package's export, and back through its import."""
    model = _port_student("attn", True)
    assert len(model.score_predictor) == 0
    params = _params("attn")
    sd = state_dict_from_jax(params)
    assert set(sd) == set(model.state_dict())
    assert not any("score_predictor" in k for k in sd)
    exported, passthrough = export_student_state_dict(
        params, {k: v.numpy() for k, v in model.state_dict().items()})
    assert not passthrough and set(exported) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], exported[k], err_msg=k)
    back, loaded, skipped = convert_student_state_dict(sd, params)
    assert set(loaded) == set(sd) and not skipped
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, v in flat:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), v, err_msg=str(path))


def test_attn_selection_needs_a_block_before_its_first_stage():
    """No block precedes a stage at block 0: there, as in the JAX model, the
    attn student scores with a predictor (its only one, `score_predictor.0`),
    and the later stages with the CLS rows (tests/test_torch_student_modes.py
    holds it against JAX)."""
    model = create_model(STUDENT, device="cpu", **MODEL, pruning_locs=(0, 2),
                         keep_ratios=(0.7, 0.49), selection="attn")
    assert len(model.score_predictor) == 1
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(_images()))
    assert [p.shape[1] for p in out.pred_logits] == [16, 11]


def test_capture_off_takes_the_whole_block():
    """Without capture (the train step's and the export's call) the blocks
    take the whole-block wrappers; the attn student captures regardless."""
    calls = []
    real = port_layers.Block.forward
    topk = _port_student("topk", True).train()
    attn = _port_student("attn", True).train()
    x = torch.from_numpy(_images())
    try:
        port_layers.Block.forward = lambda self, *a, **k: calls.append(
            k.get("return_cls_attn", False)) or real(self, *a, **k)
        topk(x, collect_cls_attns=False)
        assert calls == [False] * 4
        calls.clear()
        out = attn(x, collect_cls_attns=False)
        assert calls == [True] * 4 and len(out.cls_attns) == 4
    finally:
        port_layers.Block.forward = real


# ---- one train step of the attn student ----------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(epoch):
    """(metrics, grads) of one JAX train step of the attn student at `epoch`
    with its fused path (Pallas in interpret mode)."""
    cfg = JaxExperimentConfig(model=JaxModelConfig(use_fused_attention=True, **MODEL),
                              pruning=JaxPruningConfig(**ATTN), train=JaxTrainConfig(**TRAIN))
    student = JaxStudent(cfg=cfg.model, pruning=cfg.pruning)
    teacher = JaxTeacher(cfg=cfg.model)
    params = _params("attn")
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = _with_interpret(lambda: step(
        state, _params("teacher"), jnp.asarray(_images()), jnp.asarray(_labels()),
        jax.random.PRNGKey(3), jnp.float32(epoch)))
    return metrics, state_dict_from_jax(probed.opt_state)


@pytest.mark.parametrize("port_fused", [True, False])
def test_attn_train_step_matches_jax(port_fused):
    """Epoch 6: loss and metrics within 1e-5, every gradient within 1e-4 of
    its tensor's largest magnitude (a floor of 1e-3 of the model's largest
    gradient for those zero in exact arithmetic), cls_token and pos_embed
    unchanged. The mask loss reaches the backbone through the CLS rows of
    blocks 0 and 1, which rank the two stages."""
    metrics, grads = _jax_step(6)
    student = _port_student("attn", port_fused)
    teacher = create_model(TEACHER, device="cpu", use_fused_attention=port_fused, **MODEL)
    load_numpy_state(teacher, state_dict_from_jax(_params("teacher")))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(**TRAIN))
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = 6 * STEPS_PER_EPOCH
    before = {k: v.clone() for k, v in student.state_dict().items()}
    ops.reset_launch_counts()
    got = make_train_step(student, teacher, opt, cfg)(
        torch.from_numpy(_images()), torch.from_numpy(_labels()), 6)
    assert all(n == 0 for n in ops.launch_counts().values())  # CPU tensors
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    labels = label_params(student)
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    for name, p in student.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(p, before[name]), name
            continue
        scale = max(np.abs(grads[name]).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    # the CLS rows carry the mask loss into the first block
    assert np.abs(grads["blocks.0.attn.qkv.weight"]).max() > 0
