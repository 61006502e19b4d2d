"""Port parity of int8 serving: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The W8A8 quantization functions, the whole int8 block and the students with
quant="int8" against the JAX package's `ops/pallas/quant.py` (its plain
twin `_ref_quant_block` and the Pallas kernel in interpret mode) and its
students with every kernel in interpret mode. fp32 on the CPU; each test
states its tolerance. The port's weights are (out, in), the JAX kernels'
(in, out): the port quantizes rows where JAX quantizes columns.
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
import dense2sparse_vit_tpu.ops.pallas.predictor as jax_predictor
import dense2sparse_vit_tpu.ops.pallas.quant as jax_quant
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent

import dense2sparse_vit_torch.nn.layers as port_layers
from dense2sparse_vit_torch.core import ModelConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.ops.block import transformer_block_reference
from dense2sparse_vit_torch.ops.quant import (
    fused_transformer_block_int8,
    qmatmul,
    quant_block_reference,
    quantize_block_params,
    quantize_rows,
    quantize_weight,
)
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_ops import _block_params, load_numpy_state, random_like_tree
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

C, H, HIDDEN = 128, 2, 512
MODEL = dict(img_size=32, patch_size=8, embed_dim=C, depth=2, num_heads=H, num_classes=10)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.5,), small_predictor=True)
_KEYS = {"ln1_scale": "ln1_w", "ln1_bias": "ln1_b", "wqkv": "wqkv", "bqkv": "bqkv",
         "wproj": "wproj", "bproj": "bproj", "ln2_scale": "ln2_w", "ln2_bias": "ln2_b",
         "w1": "w1", "b1": "b1", "w2": "w2", "b2": "b2"}


def _port_weights(p):
    """JAX fused-block params (kernels (in, out)) -> the port's block dict."""
    return {_KEYS[k]: torch.from_numpy(np.ascontiguousarray(v.T) if v.ndim == 2 else v)
            for k, v in p.items()}


def test_config_rejects_unknown_and_unfused_int8():
    """The port's ModelConfig keeps the JAX config's two quant checks
    (`tests/test_quant_block.py:128-134`)."""
    with pytest.raises(ValueError, match="use_fused_attention"):
        ModelConfig(quant="int8", use_fused_attention=False)
    with pytest.raises(ValueError, match="quant"):
        ModelConfig(quant="fp4")
    assert ModelConfig(quant="int8", use_fused_attention=True).quant == "int8"


@pytest.mark.parametrize("shape,scale", [((64, 96), 0.3), ((384, 1536), 0.02), ((8, 4), 1e-12)])
def test_quantize_weight_codes_equal_jax(shape, scale):
    """Codes equal, scales within 1e-7 relative; the last case has every
    absmax under the 1e-8 floor."""
    w = (scale * np.random.default_rng(shape[0]).standard_normal(shape)).astype(np.float32)
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(w))
    got_q, got_s = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s)[0], rtol=1e-7, atol=0)


@pytest.mark.parametrize("shape", [(50, 128), (7, 1536)])
def test_quantize_rows_codes_equal_jax(shape):
    h = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
    h[0, :3] = [0.5, -0.5, 1.5]  # halves: round half to even on both sides
    want_q, want_s = jax_quant._quantize_rows(jnp.asarray(h))
    got_q, got_s = quantize_rows(torch.from_numpy(h))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7, atol=0)


@pytest.mark.parametrize("k,spread", [(128, 1.0), (1536, 0.01)])
def test_qmatmul_equals_jax(k, spread):
    """Within 1e-6. With spread 0.01 every code is ~127 and the int32 sums
    pass 2^24, where an fp32 accumulation would round: the port's exact
    float64 sum gives JAX's bits."""
    rng = np.random.default_rng(k)
    h = (1 + spread * rng.standard_normal((8, k))).astype(np.float32)
    w = (1 + spread * rng.standard_normal((k, 64))).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    wq, ws = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant._qmatmul(jnp.asarray(h), wq, ws, jnp.asarray(b)))
    tq, ts = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    got = qmatmul(torch.from_numpy(h), tq, ts, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if spread < 1:
        q, _ = quantize_rows(torch.from_numpy(h))
        assert (q.double() @ tq.double().t()).abs().max() > 2 ** 24
        np.testing.assert_array_equal(got, want)


def _block_inputs(n=24, seed=40):
    p = _block_params(C, HIDDEN, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((2, n, C)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("n", [24, 13])
def test_int8_block_matches_jax_reference_and_kernel(n):
    """The plain int8 block against JAX `_ref_quant_block` and the Pallas
    kernel in interpret mode. Tolerance: one code step at the output, the
    most a single flipped code of the last product moves an output element
    (max row scale of the activation * 127 * max column scale of fc2); with
    identical codes only fp32 rounding remains (~1e-6)."""
    p, x = _block_inputs(n)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_ref = np.asarray(jax_quant._ref_quant_block(jnp.asarray(x), jp, H))
    want_kernel = np.asarray(jax_quant.fused_transformer_block_int8(
        jnp.asarray(x), jp, H, block_batch=2, interpret=True))
    qw = quantize_block_params(_port_weights(p))
    got, st = quant_block_reference(torch.from_numpy(x), qw, H, (C // H) ** -0.5, 1e-6,
                                    stages=True)
    step = st["s4"].max().item() * 127 * qw["s2"].max().item()
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_int8_block_tracks_the_float_block():
    """Relative RMS of the difference to the fp32 block under 5%, the JAX
    test's bound (`tests/test_quant_block.py:97-108`)."""
    p, x = _block_inputs()
    w = _port_weights(p)
    xt = torch.from_numpy(x)
    q8 = quant_block_reference(xt, quantize_block_params(w), H, (C // H) ** -0.5, 1e-6)
    fp = transformer_block_reference(xt, w, H, (C // H) ** -0.5, 1e-6)
    err = ((q8 - fp).pow(2).mean().sqrt() / fp.std()).item()
    assert err < 0.05, err


def test_int8_wrapper_has_no_gradient():
    p, x = _block_inputs()
    qw = quantize_block_params(_port_weights(p))
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_transformer_block_int8(xt, qw, H)
    with torch.no_grad():
        got = fused_transformer_block_int8(xt, qw, H)
    torch.testing.assert_close(got, quant_block_reference(xt.detach(), qw, H, 0.125, 1e-6),
                               rtol=0, atol=0)


# ---- the students with quant="int8" ----------------------------------------


def _images(seed=41):
    return np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _student_params():
    student = JaxStudent(cfg=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**PRUNING))
    shapes = jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.asarray(_images()[:1]))
    return random_like_tree(shapes["params"], seed=42)


def _jax_interpret():
    """Every kernel the JAX int8 student reaches, in interpret mode (the
    monkeypatch of `tests/test_quant_block.py:137-161`), as (module, name,
    patched)."""
    gather = jax_gather.fused_gather_tokens
    return [
        (jax_quant, "fused_transformer_block_int8",
         functools.partial(jax_quant.fused_transformer_block_int8, interpret=True)),
        (jax_attention, "fused_attention_packed",
         functools.partial(jax_attention.fused_attention_packed, interpret=True)),
        (jax_block, "fused_transformer_block",
         functools.partial(jax_block.fused_transformer_block, interpret=True)),
        (jax_predictor, "fused_predictor_lg",
         functools.partial(jax_predictor.fused_predictor_lg, interpret=True)),
        (jax_gather, "fused_gather_tokens",
         lambda x, idx, block_batch=8, interpret=False: gather(x, idx, block_batch, True)),
    ]


@functools.lru_cache(maxsize=None)
def _jax_int8_forward(threshold):
    pruning = dict(PRUNING, patch_score_threshold=threshold)
    student = JaxStudent(cfg=JaxModelConfig(use_fused_attention=True, quant="int8", **MODEL),
                         pruning=JaxPruningConfig(**pruning))
    saved = [(m, n, getattr(m, n)) for m, n, _ in _jax_interpret()]
    try:
        for m, n, patched in _jax_interpret():
            setattr(m, n, patched)
        return student.apply({"params": _student_params()}, jnp.asarray(_images()),
                             collect_cls_attns=False)
    finally:
        for m, n, orig in saved:
            setattr(m, n, orig)


def _port_student(threshold=None, quant="int8"):
    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu",
                         use_fused_attention=True, quant=quant, patch_score_threshold=threshold,
                         **MODEL, **PRUNING)
    return load_numpy_state(model, state_dict_from_jax(_student_params()))


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts the Blocks' calls of the int8 wrapper."""
    calls = []
    real = port_layers.fused_transformer_block_int8

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(port_layers, "fused_transformer_block_int8", spy)
    return calls


@pytest.mark.parametrize("threshold,int8_blocks", [(None, 2), (0.5, 1)])
def test_int8_student_matches_jax(int8_calls, threshold, int8_blocks):
    """Logits within 1e-4 of the JAX int8 student's (one code step of the
    head's input is ~1e-3 here; the codes agree, so fp32 rounding is what
    remains), kept indices and keep masks exact. Top-k mode quantizes both
    blocks; threshold mode only the block before the first stage (the
    policy block stays bf16)."""
    want = _jax_int8_forward(threshold)
    model = _port_student(threshold).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_images()), collect_cls_attns=False)
    assert len(int8_calls) == int8_blocks
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(want.logits), rtol=1e-4, atol=1e-4)
    for got, w in zip(out.kept_idx, want.kept_idx):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    for got, w in zip(out.keep_masks, want.keep_masks or ()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_int8_student_trains_through_the_float_kernels(int8_calls):
    """Train mode takes the trainable bf16/fp32 path: no int8 call, and the
    same logits as a student without quant."""
    x = torch.from_numpy(_images())
    got = _port_student().train()(x).logits
    want = _port_student(quant="none").train()(x).logits
    assert not int8_calls
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()


def test_teacher_never_quantizes(int8_calls):
    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu",
                           use_fused_attention=True, quant="int8", **MODEL)
    assert all(blk.quant == "none" for blk in teacher.blocks)
    teacher(torch.from_numpy(_images()))
    assert not int8_calls


def test_int8_weights_follow_the_parameters():
    """The cached codes are remade after a weight changes in place."""
    blk = port_layers.Block(C, H, use_fused=True, quant="int8").eval()
    with torch.no_grad():
        first = blk.int8_weights(torch.float32)["wqkv_q"].clone()
        assert blk.int8_weights(torch.float32)["wqkv_q"] is blk._buffers["_int8_float32_wqkv_q"]
        blk.attn.qkv.weight.mul_(-1)
        assert torch.equal(blk.int8_weights(torch.float32)["wqkv_q"], -first)
    assert "_int8_float32_wqkv_q" not in blk.state_dict()
