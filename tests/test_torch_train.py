"""Port parity of the training slice's kernels and modules:
dense2sparse_vit_torch vs dense2sparse_vit_tpu (the train step itself is
in test_torch_train_step.py).

The same inputs and weights, drawn with numpy from fixed seeds, go through
the JAX function (its Pallas kernel in interpret mode, and its plain
reference) and through the port's counterpart, which runs its plain torch
version for CPU tensors. Comparisons are in fp32 on the CPU; each test
states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.ops.pallas.attention as jax_attention
import dense2sparse_vit_tpu.ops.pallas.block as jax_block
import dense2sparse_vit_tpu.ops.pallas.gather as jax_gather
import dense2sparse_vit_tpu.ops.pallas.mlp as jax_mlp
import dense2sparse_vit_tpu.ops.pallas.predictor as jax_predictor
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.losses.backbone_loss import backbone_loss as jax_backbone_loss
from dense2sparse_vit_tpu.losses.mask_loss import mask_loss as jax_mask_loss
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.models.teacher import ViTTeacher as JaxTeacher
from dense2sparse_vit_tpu.nn.layers import Block as JaxBlock

import dense2sparse_vit_torch.nn.layers as port_layers
import dense2sparse_vit_torch.nn.predictor as port_predictor
from dense2sparse_vit_torch.losses import backbone_loss, mask_loss
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, _port_block_state, load_numpy_state, random_like_tree

MODEL = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2,
             num_classes=10)
PRUNING = dict(pruning_locs=(1, 2, 3), keep_ratios=(0.7, 0.49, 0.343),
               small_predictor=True)
B = 2


def _images(seed=20):
    return np.random.default_rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)


def _labels():
    return np.array([3, 7])


@functools.lru_cache(maxsize=None)
def _student_params():
    student = JaxStudent(cfg=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**PRUNING))
    shapes = jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=21)


@functools.lru_cache(maxsize=None)
def _teacher_params():
    teacher = JaxTeacher(cfg=JaxModelConfig(**MODEL))
    shapes = jax.eval_shape(teacher.init, jax.random.PRNGKey(1), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=22)


def _interpret_kernels():
    """The Pallas kernels the training path reaches, in interpret mode (the
    packed attention and the MLP half: a fused training Block that captures
    its CLS rows; the predictor: an eval-mode student)."""
    gather = jax_gather.fused_gather_tokens
    mlp = jax_mlp.fused_mlp_residual

    def mlp_interpret(x, ln_s, ln_b, w1, b1, w2, b2, eps=1e-6, block_batch=8, interpret=False):
        return mlp(x, ln_s, ln_b, w1, b1, w2, b2, eps, block_batch, True)

    return [
        (jax_block, "fused_transformer_block",
         functools.partial(jax_block.fused_transformer_block, interpret=True)),
        (jax_block, "fused_transformer_block_backward",
         functools.partial(jax_block.fused_transformer_block_backward, interpret=True)),
        (jax_gather, "fused_gather_tokens",
         lambda x, idx, block_batch=8, interpret=False: gather(x, idx, block_batch, True)),
        (jax_attention, "fused_attention_packed",
         functools.partial(jax_attention.fused_attention_packed, interpret=True)),
        (jax_attention, "fused_attention_backward_packed",
         functools.partial(jax_attention.fused_attention_backward_packed, interpret=True)),
        (jax_mlp, "fused_mlp_residual", mlp_interpret),
        (jax_mlp, "fused_mlp_residual_backward",
         functools.partial(jax_mlp.fused_mlp_residual_backward, interpret=True)),
        (jax_predictor, "fused_predictor_lg",
         functools.partial(jax_predictor.fused_predictor_lg, interpret=True)),
    ]


def _with_interpret(fn):
    """Run fn() with the JAX package's Pallas kernels in interpret mode."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _interpret_kernels()]
    try:
        for mod, name, patched in _interpret_kernels():
            setattr(mod, name, patched)
        return fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


# ---- kernel A: the gather's backward -------------------------------------


def test_gather_backward_matches_pallas_scatter_bit_exactly():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 13, 16)).astype(np.float32)
    g = rng.standard_normal((2, 9, 16)).astype(np.float32)
    idx = rng.permutation(13)[:9][None].repeat(2, 0)
    # repeats sum, out-of-range indices add nothing (each row gets at most
    # two rows, so the fp32 sum is the same in any order)
    idx[0, 1], idx[0, 5] = idx[0, 4], 40
    idx[1, 0], idx[1, 8] = -1, 13
    _, vjp = jax.vjp(lambda a: jax_gather.fused_gather_tokens(
        a, jnp.asarray(idx, jnp.int32), 8, True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    out = fused_gather_tokens(xt, torch.from_numpy(idx))
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, idx[0, 4]].numpy(), g[0, 1] + g[0, 4])


# ---- kernels B and C: the block's CLS rows and its backward --------------

# B=2, N=13 (not a multiple of the TPU kernel's 16-token tile), C=64, H=2
BN, BC, BH = 13, 64, 2
BLOCK_KEYS = {  # JAX fused-block key -> port Block parameter
    "ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
    "wqkv": "attn.qkv.weight", "bqkv": "attn.qkv.bias",
    "wproj": "attn.proj.weight", "bproj": "attn.proj.bias",
    "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
    "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
    "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias",
}


def _block_case():
    p = _block_params(BC, 4 * BC, seed=24)
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, BN, BC)).astype(np.float32)
    g = rng.standard_normal((2, BN, BC)).astype(np.float32)
    return p, x, g


def test_block_backward_matches_pallas_kernel_and_reference():
    """dx and the 12 gradients; rtol/atol 2e-4 (the TPU kernel's LayerNorm
    statistics by ones-matmuls reorder fp32 sums)."""
    p, x, g = _block_case()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    dx_k, dp_k, _ = jax_block.fused_transformer_block_backward(
        jnp.asarray(x), jnp.asarray(g), jp, BH, interpret=True)
    _, vjp = jax.vjp(lambda a, q: jax_block._ref_block(a, q, BH, None, None, 1e-6),
                     jnp.asarray(x), jp)
    dx_r, dp_r = vjp(jnp.asarray(g))

    blk = load_numpy_state(Block(BC, BH, use_fused=True), _port_block_state(p)).train()
    xt = torch.from_numpy(x).requires_grad_()
    blk(xt).backward(torch.from_numpy(g))
    params = dict(blk.named_parameters())
    tol = dict(rtol=2e-4, atol=2e-4)
    for want_dx, want_dp in ((dx_k, dp_k), (dx_r, dp_r)):
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), **tol)
        for jk, pk in BLOCK_KEYS.items():
            want = np.asarray(want_dp[jk])
            want = want.T if want.ndim == 2 else want
            np.testing.assert_allclose(params[pk].grad.numpy(), want, err_msg=jk, **tol)


def _flax_block_params(p):
    """The JAX fused-block params dict as the flax Block's param tree."""
    return {
        "norm1": {"scale": p["ln1_scale"], "bias": p["ln1_bias"]},
        "attn": {"qkv": {"kernel": p["wqkv"], "bias": p["bqkv"]},
                 "proj": {"kernel": p["wproj"], "bias": p["bproj"]}},
        "norm2": {"scale": p["ln2_scale"], "bias": p["ln2_bias"]},
        "mlp": {"fc1": {"kernel": p["w1"], "bias": p["b1"]},
                "fc2": {"kernel": p["w2"], "bias": p["b2"]}},
    }


@pytest.mark.parametrize("use_fused", [True, False])
def test_block_cls_rows_match_pallas_kernel_and_flax_block(use_fused):
    """The (B, H, N) CLS rows and the block output: atol 1e-5 on the
    probabilities (~1/N each), 2e-4 on the output."""
    p, x, _ = _block_case()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out_k, cls_k = jax_block.fused_transformer_block(
        jnp.asarray(x), jp, BH, return_cls=True, exact=True, interpret=True)
    out_f, cls_f = JaxBlock(num_heads=BH).apply(
        {"params": _flax_block_params(p)}, jnp.asarray(x), return_cls_attn=True)
    blk = load_numpy_state(Block(BC, BH, use_fused=use_fused), _port_block_state(p)).eval()
    with torch.no_grad():
        out, cls = blk(torch.from_numpy(x), return_cls_attn=True)
    assert cls.shape == (2, BH, BN)
    for want_out, want_cls in ((out_k, cls_k), (out_f, cls_f)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=1e-4, atol=1e-5)


def test_block_dispatch_follows_the_jax_block(monkeypatch):
    """Fused: eval -> fused_transformer_block, train ->
    fused_transformer_block_trainable, CLS capture in eval ->
    fused_transformer_block_cls, CLS capture in train (with autograd or
    without) -> the packed attention with its CLS rows and the MLP half; the
    train-mode forwards equal the eval ones."""
    calls = []
    for name in ("fused_transformer_block", "fused_transformer_block_trainable",
                 "fused_transformer_block_cls", "fused_attention_packed_with_cls_trainable",
                 "fused_mlp_residual"):
        real = getattr(port_layers, name)
        monkeypatch.setattr(port_layers, name, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k), real, name))
    p, x, _ = _block_case()
    blk = load_numpy_state(Block(BC, BH, use_fused=True), _port_block_state(p))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want = blk.eval()(xt)
        want_cls = blk.eval()(xt, return_cls_attn=True)
    got = blk.train()(xt)
    assert calls == ["fused_transformer_block", "fused_transformer_block_cls",
                     "fused_transformer_block_trainable"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    calls.clear()
    got_cls = blk(xt, return_cls_attn=True)
    with torch.no_grad():
        blk(xt, return_cls_attn=True)
    assert calls == ["fused_attention_packed_with_cls_trainable", "fused_mlp_residual"] * 2
    for a, b in zip(got_cls, want_cls):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- the teacher ----------------------------------------------------------


@pytest.mark.parametrize("jax_fused", [True, False])
@pytest.mark.parametrize("port_fused", [True, False])
def test_teacher_matches_jax(jax_fused, port_fused):
    """logits, tokens and the (B, L, H, N+1) CLS stack within 1e-4."""
    teacher = JaxTeacher(cfg=JaxModelConfig(use_fused_attention=jax_fused, **MODEL))
    run = jax.jit(lambda prm, im: teacher.apply({"params": prm}, im))
    want = _with_interpret(lambda: run(_teacher_params(), jnp.asarray(_images())))
    port = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu",
                        use_fused_attention=port_fused, **MODEL)
    load_numpy_state(port, state_dict_from_jax(_teacher_params()))
    got = port(torch.from_numpy(_images()))
    assert got[2].shape == (B, 4, 2, 17)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    assert not any(t.requires_grad for t in got)


def test_teacher_state_dict_keys_are_the_jax_params():
    port = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu", **MODEL)
    sd = state_dict_from_jax(_teacher_params())
    assert set(sd) == set(port.state_dict())
    assert not any("score_predictor" in k for k in sd)


# ---- the predictor's dispatch --------------------------------------------


def test_predictor_kernel_runs_only_in_eval_mode(monkeypatch):
    calls = []
    real = port_predictor.fused_predictor_lg
    monkeypatch.setattr(port_predictor, "fused_predictor_lg",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu",
                         use_fused_attention=True, **MODEL, **PRUNING)
    x = torch.from_numpy(_images())
    with torch.no_grad():
        want = model.eval()(x)
    assert len(calls) == 3
    got = model.train()(x)
    assert len(calls) == 3  # train mode: the plain layers, under autograd
    assert got.pred_logits[0].requires_grad
    for g, w in zip(got.pred_logits, want.pred_logits):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# ---- the losses -----------------------------------------------------------


def _mask_inputs(seed=26):
    rng = np.random.default_rng(seed)
    n, ks = 16, (11, 7, 5)
    logits = [rng.standard_normal((B, m)).astype(np.float32) for m in (n,) + ks[:2]]
    attns = rng.random((B, 4, 2, n + 1)).astype(np.float32)
    kept = []
    for m, k in zip((n,) + ks[:2], ks):
        kept.append(np.sort(np.stack([rng.permutation(m)[:k] for _ in range(B)]), axis=1))
    return logits, attns, kept


@pytest.mark.parametrize("loss_type", ["kl_div", "mse", "bce"])
@pytest.mark.parametrize("mean_heads", [False, True])
def test_mask_loss_matches_jax(loss_type, mean_heads):
    """Value, metrics and the logits' gradients within 1e-5, three stages
    chained by kept_idx."""
    logits, attns, kept = _mask_inputs()
    ratios = PRUNING["keep_ratios"]

    def jax_fn(ls):
        return jax_mask_loss(ls, jnp.asarray(attns), [jnp.asarray(k) for k in kept],
                             ratios, loss_type, mean_heads)

    (want, want_m), want_g = jax.value_and_grad(jax_fn, has_aux=True)(
        [jnp.asarray(l) for l in logits])
    lt = [torch.from_numpy(l).requires_grad_() for l in logits]
    got, got_m = mask_loss(lt, torch.from_numpy(attns), [torch.from_numpy(k) for k in kept],
                           ratios, loss_type, mean_heads)
    got_g = torch.autograd.grad(got, lt)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(want), **tol)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), err_msg=k, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("form", ["live", "probs", "keep_mask", "soft_labels"])
def test_backbone_loss_matches_jax(form):
    """Value, metrics and the student inputs' gradients within 1e-5."""
    rng = np.random.default_rng(27)
    n, k, d, c = 16, 5, 8, 10
    ls, lt = (rng.standard_normal((B, c)).astype(np.float32) for _ in range(2))
    ts = rng.standard_normal((B, k if form != "keep_mask" else n, d)).astype(np.float32)
    tt = rng.standard_normal((B, n, d)).astype(np.float32)
    kept = np.sort(np.stack([rng.permutation(n)[:k] for _ in range(B)]), axis=1)
    labels = _labels()
    kw = {}
    if form == "probs":
        q = np.exp(tt) / np.exp(tt).sum(-1, keepdims=True)
        kw = dict(tokens_t_probs=q, tokens_t_entropy=(q * np.log(q)).sum(-1))
    if form == "keep_mask":
        kw = dict(keep_mask=(rng.random((B, n)) < 0.5).astype(np.float32))
    else:
        kw["kept_idx_orig"] = kept
    if form == "soft_labels":
        labels = rng.dirichlet(np.ones(c), B).astype(np.float32)
        kw["mixup_active"] = True
    tokens_t = None if form == "probs" else tt

    def conv(v, fw):
        return v if isinstance(v, bool) or v is None else fw(v)

    def jax_fn(a, b):
        return jax_backbone_loss(a, b, jnp.asarray(lt), conv(tokens_t, jnp.asarray),
                                 jnp.asarray(labels),
                                 **{key: conv(v, jnp.asarray) for key, v in kw.items()})

    (want, want_m), want_g = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ls), jnp.asarray(ts))
    a = torch.from_numpy(ls).requires_grad_()
    b = torch.from_numpy(ts).requires_grad_()
    got, got_m = backbone_loss(a, b, torch.from_numpy(lt), conv(tokens_t, torch.from_numpy),
                               torch.from_numpy(labels),
                               **{key: conv(v, torch.from_numpy) for key, v in kw.items()})
    got_g = torch.autograd.grad(got, (a, b))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(want), **tol)
    for key in want_m:
        np.testing.assert_allclose(got_m[key].item(), float(want_m[key]), err_msg=key, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
