"""Port parity of the T2T-ViT slice: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The T2T stem (unfold, the sinusoid table, both T2T units, the three
stems), the dense T2T-ViT and the pruned T2T student in eval mode, the
state_dict map, the whole block with DropPath branch scales both ways
against the Pallas kernels in interpret mode, and stochastic-depth training
(the dense T2T-ViT's gradients at drop path 0.3, the transformer-stem
student's train step) fed the JAX package's own branch scales: the test
records them where the JAX Block hands them to
`fused_transformer_block_trainable` and the port's draw helper returns them.
Shapes follow `tests/test_pruned_backbones.py` (64 px, C 32, depth 4, token
dim 16). Inputs and weights come from numpy seeds; comparisons are in fp32
on the CPU, each with its stated tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.block as jax_block
from dense2sparse_vit_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.core.config import TrainConfig as JaxTrainConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.t2t import T2TViT as JaxT2TViT
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.nn import t2t as jax_t2t
from dense2sparse_vit_tpu.train.optimizer import label_params as jax_label_params
from dense2sparse_vit_tpu.train.train_step import TrainState
from dense2sparse_vit_tpu.train.train_step import make_train_step as jax_make_train_step

import dense2sparse_vit_torch.nn.layers as port_layers
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, ModelConfig, PruningConfig, TrainConfig
from dense2sparse_vit_torch.models import DiffPruningStudent, T2TViT, ViTTeacher, create_model
from dense2sparse_vit_torch.models import registry
from dense2sparse_vit_torch.nn import t2t
from dense2sparse_vit_torch.nn.layers import Block, draw_branch_scales
from dense2sparse_vit_torch.ops.block import (
    fused_transformer_block,
    fused_transformer_block_backward,
)
from dense2sparse_vit_torch.train import label_params, make_optimizer, make_train_step
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, _port_block_state, load_numpy_state, random_like_tree
from test_torch_policy import PORT_KEYS, _port_weights
from test_torch_train import _with_interpret
from test_torch_train_step import _grad_probe

B, IMG, C, TD = 2, 64, 32, 16  # T2T strides 4 * 2 * 2 = 16 -> 4 x 4 = 16 tokens
TINY = dict(img_size=IMG, patch_size=16, embed_dim=C, depth=4, num_heads=2, qkv_bias=False,
            layer_norm_eps=1e-5, num_classes=5)
PRUNING = dict(pruning_locs=(1, 2), keep_ratios=(0.75, 0.5))
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, the same arithmetic in another order


def _images(b=B, img=IMG, seed=40):
    return np.random.default_rng(seed).standard_normal((b, img, img, 3)).astype(np.float32)


def _init(module, *args, seed, **kwargs):
    """numpy-drawn params of the shapes `module.init` gives."""
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs), jax.random.PRNGKey(0),
                            *args)
    return random_like_tree(shapes["params"], seed=seed)


def _stem_state(params, unit=None):
    """The port keys of a JAX stem's (or one T2T unit's) params, relative
    to the port module."""
    tree = {"stem": params if unit is None else {unit: params}}
    prefix = "tokens_to_token." + ("" if unit is None else unit + ".")
    return {k[len(prefix):]: v for k, v in state_dict_from_jax(tree).items()}


def _rel_close(got, want, rel, name=""):
    """|got - want| <= rel * max|want|, elementwise."""
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale, err_msg=name)


# ---- the stem --------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride,padding", [(7, 4, 2), (3, 2, 1)])
def test_unfold_matches_jax_patch_order(kernel, stride, padding):
    x = np.random.default_rng(41).standard_normal((2, 16, 16, 5)).astype(np.float32)
    want = jax_t2t.unfold(jnp.asarray(x), kernel, stride, padding)
    got = t2t.unfold(torch.from_numpy(x), kernel, stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)


def test_sinusoid_table_is_the_jax_table():
    np.testing.assert_array_equal(t2t.get_sinusoid_encoding(197, 384),
                                  jax_t2t.get_sinusoid_encoding(197, 384))


@pytest.mark.parametrize("unit", ["performer", "transformer"])
def test_stem_unit_matches_jax(unit):
    """One T2T unit in eval mode on (B, 64, 147) tokens, within TOL."""
    x = np.random.default_rng(42).standard_normal((B, 64, 147)).astype(np.float32)
    if unit == "performer":
        mod, port = jax_t2t.TokenPerformer(in_dim=TD), t2t.TokenPerformer(147, TD)
    else:
        mod, port = jax_t2t.TokenTransformer(in_dim=TD), t2t.TokenTransformer(147, TD)
    params = _init(mod, jnp.asarray(x), seed=43)
    want = mod.apply({"params": params}, jnp.asarray(x))
    load_numpy_state(port, _stem_state(params, "attention1")).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tokens_type", ["performer", "transformer", "convolution"])
def test_t2t_module_matches_jax(tokens_type):
    x = _images()
    mod = jax_t2t.T2TModule(embed_dim=C, tokens_type=tokens_type, token_dim=TD)
    params = _init(mod, jnp.asarray(x), seed=44)
    want = mod.apply({"params": params}, jnp.asarray(x))
    port = load_numpy_state(t2t.T2TModule(C, tokens_type, TD), _stem_state(params)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (B, 16, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_performer_dropout_draws_from_the_generator():
    """The performer's train-mode dropout cannot match flax's bits: held by
    its rate (the share of zeros within 0.01 of 0.1 over 2e5 draws, the kept
    values x / 0.9) and by its generator (the same seed, the same output;
    another seed, another; none, an error)."""
    x = torch.randn((200_000,), generator=torch.Generator().manual_seed(0))
    y = t2t.dropout(x, 0.1, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.1) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.9, rtol=0, atol=0)

    stem = t2t.T2TModule(C, "performer", TD).train()
    imgs = torch.from_numpy(_images())
    with torch.no_grad():
        a = stem(imgs, torch.Generator().manual_seed(5))
        b = stem(imgs, torch.Generator().manual_seed(5))
        c = stem(imgs, torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="Generator"):
            stem(imgs)
        assert torch.equal(stem.eval()(imgs), stem(imgs))  # eval: no dropout
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---- the models in eval mode -------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_t2t_vit(tokens_type):
    model = JaxT2TViT(cfg=JaxModelConfig(**TINY), tokens_type=tokens_type, token_dim=TD)
    return model, _init(model, jnp.asarray(_images()[:1]), seed=45)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("get_average", [False, True])
def test_dense_t2t_vit_matches_jax(use_fused, get_average):
    model, params = _jax_t2t_vit("performer")
    want = model.apply({"params": params}, jnp.asarray(_images()), get_average=get_average)
    port = T2TViT(ModelConfig(use_fused_attention=use_fused, **TINY), "performer", TD)
    load_numpy_state(port, state_dict_from_jax(params)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_images()), get_average=get_average)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_student(tokens_type, **model):
    return JaxStudent(
        cfg=JaxModelConfig(**{**TINY, **model}), pruning=JaxPruningConfig(**PRUNING),
        stem=jax_t2t.T2TModule(embed_dim=C, tokens_type=tokens_type, token_dim=TD,
                               name="tokens_to_token"),
        pos_embed_type="sinusoid")


def _port_student(tokens_type, **model):
    return DiffPruningStudent(ModelConfig(**{**TINY, **model}), PruningConfig(**PRUNING),
                              stem=t2t.T2TModule(C, tokens_type, TD), pos_embed_type="sinusoid")


@functools.lru_cache(maxsize=None)
def _student_params(tokens_type):
    return _init(_jax_student(tokens_type), jnp.asarray(_images()[:1]), seed=46)


@pytest.mark.parametrize("tokens_type", ["performer", "transformer"])
@pytest.mark.parametrize("use_fused", [False, True])
def test_pruned_t2t_student_matches_jax(tokens_type, use_fused):
    """Logits and features within TOL, the kept indices exact."""
    params = _student_params(tokens_type)
    want = _jax_student(tokens_type).apply({"params": params}, jnp.asarray(_images()),
                                           collect_cls_attns=False)
    port = load_numpy_state(_port_student(tokens_type, use_fused_attention=use_fused),
                            state_dict_from_jax(params)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_images()), collect_cls_attns=False)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **TOL)
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), **TOL)
    for g, w in zip(got.kept_idx, want.kept_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tokens_type", ["performer", "convolution"])
def test_state_dict_round_trip(tokens_type):
    """JAX params -> state_dict_from_jax -> the port's strict load -> the
    port's state_dict: the same keys and values; no pos_embed (the sinusoid
    table is a constant), and the performer's projection untransposed."""
    model = JaxT2TViT(cfg=JaxModelConfig(**TINY), tokens_type=tokens_type, token_dim=TD)
    params = _init(model, jnp.asarray(_images()[:1]), seed=47)
    sd = state_dict_from_jax(params)
    port = load_numpy_state(T2TViT(ModelConfig(**TINY), tokens_type, TD), sd)
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    assert set(got) == set(sd) and "pos_embed" not in got
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k], err_msg=k)
    if tokens_type == "performer":
        np.testing.assert_array_equal(
            got["tokens_to_token.attention1.w"],
            params["tokens_to_token"]["attention1"]["prm_w"])
    # the pruned student binds its stem under `stem`: the same port keys
    student = state_dict_from_jax(_student_params("performer"))
    assert {k for k in student if k.startswith("tokens_to_token.")} == {
        k for k in state_dict_from_jax(_jax_t2t_vit("performer")[1])
        if k.startswith("tokens_to_token.")}


def test_registry_builds_the_t2t_family_on_the_cpu():
    """On the card by default, on the CPU when asked."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_model("t2t_vit_14_student")
    student = create_model("t2t_vit_14_student", device="cpu", dtype="bfloat16",
                           use_fused_attention=True)
    assert student.cfg.embed_dim == 384 and student.cfg.depth == 14
    assert student.cfg.mlp_ratio == 3.0 and not student.cfg.qkv_bias
    assert student.pos_embed_type == "sinusoid" and "pos_embed" not in student.state_dict()
    assert student.pruning.keep_counts(196) == (137, 96, 67)
    dense = create_model("t2t_vit_14", device="cpu")
    assert dense.tokens_type == "performer" and len(dense.blocks) == 14
    assert sum(p.numel() for p in dense.parameters()) == 21_469_902  # the reference's: 21.5M
    assert registry._REGISTRY["t2t_vit_t_14"]().tokens_type == "transformer"  # built, not drawn


# ---- the block with DropPath branch scales, both ways ---------------------

BN, BC, BH = 13, 64, 2
SCALES = (np.array([0.0, 1 / 0.7], np.float32), np.array([1 / 0.7, 0.0], np.float32))


def _scaled_block_case(policy):
    p = _block_params(BC, 4 * BC, seed=48)
    rng = np.random.default_rng(49)
    x = rng.standard_normal((2, BN, BC)).astype(np.float32)
    g = rng.standard_normal((2, BN, BC)).astype(np.float32)
    pol = None
    if policy:
        pol = (rng.random((2, BN)) < 0.6).astype(np.float32)
        pol[:, 0] = 1.0
    return p, x, g, pol


@pytest.mark.parametrize("policy", [False, True])
def test_scaled_block_forward_matches_pallas_kernel(policy):
    """Each sample drops one branch and scales the other by 1/keep; within
    2e-4 (the TPU kernel folds LayerNorm into the weights)."""
    p, x, _, pol = _scaled_block_case(policy)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jpol = None if pol is None else jnp.asarray(pol)
    bs = tuple(jnp.asarray(s) for s in SCALES)
    want_k = jax_block.fused_transformer_block(jnp.asarray(x), jp, BH, jpol, branch_scales=bs,
                                               interpret=True)
    want_r = jax_block._ref_block(jnp.asarray(x), jp, BH, jpol, None, 1e-6, bs)
    got = fused_transformer_block(torch.from_numpy(x), _port_weights(p), BH,
                                  None if pol is None else torch.from_numpy(pol),
                                  branch_scales=tuple(torch.from_numpy(s) for s in SCALES))
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    plain = fused_transformer_block(torch.from_numpy(x), _port_weights(p), BH,
                                    None if pol is None else torch.from_numpy(pol))
    assert not torch.allclose(got, plain, atol=1e-2)  # the scales reach the output


@pytest.mark.parametrize("policy", [False, True])
def test_scaled_block_backward_matches_pallas_kernel(policy):
    """dx, the 12 gradients and dPolicy against the Pallas backward with the
    same scales; rtol/atol 2e-4 as the unscaled backward's test."""
    p, x, g, pol = _scaled_block_case(policy)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    dx_k, dp_k, dpol_k = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, BH, None if pol is None else jnp.asarray(pol),
        branch_scales=tuple(jnp.asarray(s) for s in SCALES), interpret=True)
    dx, dw, dpol = fused_transformer_block_backward(
        torch.from_numpy(x), torch.from_numpy(g), _port_weights(p), BH,
        None if pol is None else torch.from_numpy(pol),
        branch_scales=tuple(torch.from_numpy(s) for s in SCALES))
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_k), **tol)
    for jk, pk in PORT_KEYS.items():
        want = np.asarray(dp_k[jk])
        np.testing.assert_allclose(dw[pk].numpy(), want.T if want.ndim == 2 else want,
                                   err_msg=jk, **tol)
    if policy:
        np.testing.assert_allclose(dpol.numpy(), np.asarray(dpol_k), **tol)


# ---- the Block's stochastic depth ------------------------------------------


def test_draw_branch_scales_are_bernoulli_over_keep():
    sa, sm = draw_branch_scales(4096, 0.25, torch.Generator().manual_seed(0))
    for s in (sa, sm):
        assert s.dtype == torch.float32 and s.shape == (4096,)
        assert set(s.unique().tolist()) == {0.0, float(np.float32(1) / np.float32(0.75))}
        assert abs((s == 0).float().mean().item() - 0.25) < 0.03
    again = draw_branch_scales(4096, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(sa, again[0]) and torch.equal(sm, again[1]) and not torch.equal(sa, sm)


@pytest.mark.parametrize("cls", [False, True])
def test_drop_path_block_routes_draw_alike(cls):
    """One generator state gives the fused route (the trainable whole block;
    with CLS capture: the packed attention, then the plain Mlp) and the
    plain route the same draws: outputs and gradients within 1e-5."""
    p = _block_params(BC, 4 * BC, seed=50)
    x = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (4, BN, BC)).astype(np.float32))
    results = []
    for fused in (False, True):
        blk = load_numpy_state(Block(BC, BH, drop_path=0.4, use_fused=fused),
                               _port_block_state(p)).train()
        xs = x.clone().requires_grad_()
        out = blk(xs, return_cls_attn=cls, generator=torch.Generator().manual_seed(7))
        out = out[0] if cls else out
        out.square().sum().backward()
        results.append((out.detach(), xs.grad, blk.attn.qkv.weight.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    eval_out = load_numpy_state(Block(BC, BH, drop_path=0.4, use_fused=True),
                                _port_block_state(p)).eval()(x)
    assert not torch.allclose(results[0][0], eval_out, atol=1e-3)  # some branch dropped


# ---- training with stochastic depth, fed JAX's draws -----------------------


def _recording(calls):
    """A stand-in for the JAX package's fused_transformer_block_trainable
    that hands each call's branch scales to `calls` (as numpy, in program
    order, through an ordered debug callback) before running it."""
    real = jax_block.fused_transformer_block_trainable

    def record(*args):
        calls.append(tuple(np.asarray(a) for a in args))

    def spy(x, params, num_heads, policy=None, scale=None, ln_eps=1e-6, branch_scales=None):
        if branch_scales is not None:
            jax.debug.callback(record, *branch_scales, ordered=True)
        return real(x, params, num_heads, policy, scale, ln_eps, branch_scales)

    return spy


def _replay(monkeypatch, calls):
    """The port's draw helper returns the recorded scales, in order."""
    queue = list(calls)

    def replay(batch, rate, generator):
        sa, sm = queue.pop(0)
        assert sa.shape == (batch,)
        return torch.from_numpy(sa.copy()), torch.from_numpy(sm.copy())

    monkeypatch.setattr(port_layers, "draw_branch_scales", replay)
    return queue


# the JAX package's pin of this route (tests/test_pallas_block.py:181-230)
PIN = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=5,
           drop_path_rate=0.3, use_fused_attention=True, mlp_ratio=1.0)


@pytest.mark.parametrize("use_fused", [False, True])
def test_dense_t2t_vit_drop_path_gradients_match_jax(monkeypatch, use_fused):
    """The pin's model and loss (sum(logits^2) / 1000) at drop path 0.3:
    every gradient within 1e-4 of its tensor's largest magnitude."""
    model = JaxT2TViT(cfg=JaxModelConfig(**PIN), tokens_type="transformer", token_dim=16)
    x = _images(4, 32, seed=52)
    params = _init(model, jnp.asarray(x[:1]), seed=53)
    calls = []
    monkeypatch.setattr(jax_block, "fused_transformer_block_trainable", _recording(calls))

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(x), deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(113)})
        return jnp.sum(logits ** 2) / 1000.0

    grads = _with_interpret(lambda: jax.jit(jax.grad(loss))(params))
    jax.effects_barrier()
    assert len(calls) == 1  # block 1 draws; block 0's rate is 0
    want = state_dict_from_jax(grads)

    port = T2TViT(ModelConfig(**{**PIN, "use_fused_attention": use_fused}), "transformer", 16)
    load_numpy_state(port, state_dict_from_jax(params)).train()
    left = _replay(monkeypatch, calls)
    out = port(torch.from_numpy(x), generator=torch.Generator())
    (out.square().sum() / 1000.0).backward()
    assert not left
    for name, p in port.named_parameters():
        _rel_close(p.grad.numpy(), want[name], 1e-4, name)


TRAIN = dict(epochs=10, warmup_epochs=5)
STEPS_PER_EPOCH, EPOCH = 3, 6


def _set_schedule_count(opt_state, count):
    return jax.tree_util.tree_map(
        lambda s: s._replace(count=jnp.asarray(count, jnp.int32))
        if isinstance(s, optax.ScaleByScheduleState) else s,
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))


def test_t2t_student_train_step_matches_jax(monkeypatch):
    """One step of the transformer-stem student at drop path 0.3 with its
    patch-embedding teacher (the JAX loop's pairing), past warmup: the loss
    and metrics within 1e-5, every gradient within 1e-4 of its tensor's
    largest magnitude (the JAX step's kernels in interpret mode)."""
    model = dict(drop_path_rate=0.3, use_fused_attention=True)
    cfg = JaxExperimentConfig(model=JaxModelConfig(**TINY, **model),
                              pruning=JaxPruningConfig(**PRUNING),
                              train=JaxTrainConfig(**TRAIN))
    student = _jax_student("transformer", **model)
    teacher = JaxTeacher(cfg=cfg.model)
    imgs, labels = _images(), np.array([3, 1])
    params = _student_params("transformer")
    t_params = _init(teacher, jnp.asarray(imgs[:1]), seed=54)
    calls = []
    monkeypatch.setattr(jax_block, "fused_transformer_block_trainable", _recording(calls))
    probe = _grad_probe()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=probe.init(params))
    step = jax.jit(jax_make_train_step(student, teacher, probe, cfg))
    probed, metrics = _with_interpret(lambda: step(
        state, t_params, jnp.asarray(imgs), jnp.asarray(labels), jax.random.PRNGKey(3),
        jnp.float32(EPOCH)))
    jax.effects_barrier()
    assert len(calls) == 3  # blocks 1-3
    grads = state_dict_from_jax(probed.opt_state)

    port = load_numpy_state(_port_student("transformer", **model), state_dict_from_jax(params))
    p_teacher = load_numpy_state(ViTTeacher(ModelConfig(**TINY, **model)),
                                 state_dict_from_jax(t_params))
    pcfg = ExperimentConfig(model=port.cfg, pruning=port.pruning, train=TrainConfig(**TRAIN))
    opt = make_optimizer(port, pcfg.train, STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    left = _replay(monkeypatch, calls)
    got = make_train_step(port, p_teacher, opt, pcfg)(
        torch.from_numpy(imgs), torch.from_numpy(labels), EPOCH)
    assert not left and all(n == 0 for n in ops.launch_counts().values())
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # the predictors' last biases shift all of a sample's scores alike, which
    # the softmax ignores: zero in exact arithmetic, held to 1e-4 of a floor
    # of 1e-3 of the model's largest gradient (as test_torch_train_step does)
    floor = 1e-3 * max(np.abs(v).max() for v in grads.values())
    labels_of = label_params(port)
    for name, p in port.named_parameters():
        if labels_of[name] != "frozen":
            scale = max(np.abs(grads[name]).max(), floor)
            np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0, atol=1e-4 * scale,
                                       err_msg=name)


def test_performer_projection_is_frozen():
    """The performer's `w` is in the frozen group, as JAX's `prm_w`, and an
    AdamW step leaves it as it was while the rest of the stem moves."""
    params = _student_params("performer")
    want = {k: str(v) for k, v in state_dict_from_jax(jax_label_params(params)).items()}
    port = load_numpy_state(_port_student("performer"), state_dict_from_jax(params)).train()
    assert label_params(port) == want
    assert want["tokens_to_token.attention1.w"] == "frozen"
    opt = make_optimizer(port, TrainConfig(**TRAIN), STEPS_PER_EPOCH)
    opt.count = EPOCH * STEPS_PER_EPOCH
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = port(torch.from_numpy(_images()), collect_cls_attns=False,
               generator=torch.Generator().manual_seed(0))
    out.logits.square().sum().backward()
    opt.step()
    for unit in ("attention1", "attention2"):
        key = f"tokens_to_token.{unit}.w"
        assert torch.equal(port.state_dict()[key], before[key])
        assert not torch.equal(port.state_dict()[f"tokens_to_token.{unit}.kqv.weight"],
                               before[f"tokens_to_token.{unit}.kqv.weight"])
    with pytest.raises(ValueError, match="Generator"):
        port(torch.from_numpy(_images()))  # train mode: the performer's dropout
