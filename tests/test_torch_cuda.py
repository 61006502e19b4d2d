"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode) and
skip elsewhere; they import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m gpu

Weights are drawn at N(0, 1/fan_in) rather than the init's std 0.02, so that
attention rows are peaked and the softmax is exercised. Tolerances are for
bf16 and relative to the largest magnitude of the plain output: the two
versions round to bf16 at different points.
"""

import copy
import os
import sys

import pytest
import torch

import dense2sparse_vit_torch.ops.block as block_ops
import dense2sparse_vit_torch.ops.gemm as gemm_ops
import dense2sparse_vit_torch.ops.norm as norm_ops
import dense2sparse_vit_torch.ops.quant as quant_ops
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.models import (
    HEADLINE_KWARGS, HEADLINE_MODEL, HEADLINE_TEACHER, create_model)
from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.ops.attention import (
    ATTN_BLOCK_KEYS, attention_backward_reference, attention_block_backward_reference,
    attention_block_reference, attention_variant_reference, paired_attention_reference)
from dense2sparse_vit_torch.ops.block import (
    BLOCK_WEIGHT_KEYS, transformer_block_backward_reference, transformer_block_reference)
from dense2sparse_vit_torch.ops.block import attention_reference
from dense2sparse_vit_torch.ops.gather import gather_tokens_reference, scatter_tokens_reference
from dense2sparse_vit_torch.ops.mlp import (
    mlp_residual_backward_reference, mlp_residual_reference)
from dense2sparse_vit_torch.ops.predictor import (
    predictor_lg_reference, predictor_lg_split_reference)
from dense2sparse_vit_torch.ops.quant import quant_block_reference, quantize_rows
from dense2sparse_vit_torch.train import make_optimizer, make_train_step
from dense2sparse_vit_torch.ops import _cuda
from dense2sparse_vit_torch.utils.export import export_student, load_exported

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.gpu
TOL = 2e-2
# the block backward: dx and each of the twelve gradients, relative to that
# tensor's largest magnitude; the plain version rounds every intermediate
# gradient to bf16, the kernel keeps the LayerNorm and residual ones in fp32
BWD_TOL = 3e-2
NO_LAUNCHES = dict.fromkeys(ops.KERNEL_NAMES, 0)

# the LayerNorm backward's and the column sums' launches in block and half-block
# backwards, and the attention core backward's in every backward with attention
_norm = chip_smoke.norm_launches
_core = chip_smoke.core_launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _sharpen(module, seed):
    """Redraw every matrix at N(0, 1/fan_in) and perturb the LayerNorms."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            elif "norm" in name or isinstance(module, PredictorLG):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return module


def _assert_close(got, want, tol=TOL):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("n,k", [(197, 138), (138, 97), (97, 68)])
def test_gather_bit_equal(cuda, n, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8, n, 384), generator=g, device=cuda).to(torch.bfloat16)
    idx = torch.randint(0, n, (8, k), generator=g, device=cuda)
    idx[0, 0], idx[3, 5], idx[7, k - 1] = -1, n, n + 100
    before = ops.fused_gather_tokens.launches
    got = ops.fused_gather_tokens(x, idx)
    torch.cuda.synchronize()
    assert ops.fused_gather_tokens.launches == before + 1
    assert torch.equal(got, gather_tokens_reference(x, idx))
    assert not got[0, 0].any() and not got[7, k - 1].any()


@pytest.mark.parametrize("n,k", [(197, 138), (138, 97), (97, 68)])
def test_scatter_bit_equal_on_unique_indices(cuda, n, k):
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = torch.randn((8, k, 384), generator=g, device=cuda).to(torch.bfloat16)
    idx = torch.argsort(torch.rand((8, n), generator=g, device=cuda), dim=1)[:, :k]
    before = ops.fused_scatter_tokens.launches
    got = ops.fused_scatter_tokens(rows, idx.contiguous(), n)
    torch.cuda.synchronize()
    assert ops.fused_scatter_tokens.launches == before + 1
    assert torch.equal(got, scatter_tokens_reference(rows, idx, n))


# (B, K, N, D): repeats among a few rows; K = 8192, the kernel's limit, into
# rows that each collect ~40 sources; N = 33, one row past a CTA's 32
SCATTER_CASES = [(4, 50, 13, 64), (2, 8192, 197, 384), (3, 40, 33, 384)]


@pytest.mark.parametrize("b,k,n,d", SCATTER_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_sums_repeats_and_drops_out_of_range(cuda, dtype, b, k, n, d):
    """Repeated indices sum in ascending k, in fp32, so the result is bit for
    bit the plain version's on the CPU (a sequential index_add_); indices
    below 0 or at N and past contribute nothing."""
    g = torch.Generator(device=cuda).manual_seed(2)
    rows = torch.randn((b, k, d), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, n, (b, k), generator=g, device=cuda)
    idx[0, 0], idx[1, 7], idx[b - 1, k - 1] = -1, n, n + 99
    before = ops.fused_scatter_tokens.launches
    got = ops.fused_scatter_tokens(rows, idx, n)
    torch.cuda.synchronize()
    assert ops.fused_scatter_tokens.launches == before + 1
    assert torch.equal(got.cpu(), scatter_tokens_reference(rows.cpu(), idx.cpu(), n))


def test_gather_backward_is_the_scatter(cuda):
    x = torch.randn((4, 197, 384), device=cuda).to(torch.bfloat16).requires_grad_()
    idx = torch.argsort(torch.rand((4, 197), device=cuda), dim=1)[:, :138].contiguous()
    ops.reset_launch_counts()
    out = ops.fused_gather_tokens(x, idx)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_gather_tokens": 1,
                                   "fused_scatter_tokens": 1}
    assert torch.equal(x.grad, scatter_tokens_reference(g, idx, 197))


@pytest.mark.parametrize("n", [197, 138, 97, 68, 13, 1, 577])
@pytest.mark.parametrize("c,heads", [(384, 6), (768, 12)])
def test_block_kernel(cuda, c, heads, n):
    blk = _sharpen(Block(c, heads, use_fused=True), seed=n).to(cuda).eval()
    x = torch.randn((4, n, c), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        w = blk.kernel_weights(torch.bfloat16)
        got = ops.fused_transformer_block(x, w, heads)
        want = transformer_block_reference(x, w, heads, blk.attn.scale, 1e-6)
        torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.parametrize("n", [197, 138, 13, 1])
def test_block_cls_rows(cuda, n):
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda).eval()
    x = torch.randn((4, n, 384), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        w = blk.kernel_weights(torch.bfloat16)
        got, cls = ops.fused_transformer_block_cls(x, w, 6)
        want, want_cls = transformer_block_reference(
            x, w, 6, blk.attn.scale, 1e-6, return_cls=True)
        plain_kernel = ops.fused_transformer_block(x, w, 6)
        torch.cuda.synchronize()
    assert cls.shape == (4, 6, n) and cls.dtype == torch.bfloat16
    assert torch.equal(got, plain_kernel)
    _assert_close(cls, want_cls)
    torch.testing.assert_close(cls.float().sum(-1), torch.ones((4, 6), device=cuda),
                               rtol=0, atol=2e-2)


def _block_core(x, w, heads, scale, policy=None, eps=1e-6):
    """One d2s_block_forward call with every optional output: (the qkv its
    attention core read, the core's output, the (B, H, N) CLS rows, the
    rows' statistics: plain mode (B, H, N) log-sum-exp, policy mode
    (B, H, N, 4) max, denominator, ties, 0). Past 800 tokens the core is
    attention_hd_kernel, whose plain-mode statistics are (lse, 0, 0, 0)
    float4: their log-sum-exp is returned."""
    B, N, C = x.shape
    hidden, ptrs, _ = block_ops._kernel_args(x, w, heads, "core", policy=policy is not None)
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    qkv = torch.empty((B, N, 3 * C), dtype=bf16, device=dev)
    out, attn, mid = (torch.empty_like(x) for _ in range(3))
    hid = torch.empty((B, N, hidden), dtype=bf16, device=dev)
    stats = torch.empty((B * N, 2), dtype=f32, device=dev)
    four = block_ops.lse_is_float4(N, C // heads, policy is not None)
    lse = torch.empty((B, heads, N) + ((4,) if four else ()), dtype=f32, device=dev)
    cls = torch.empty((B, heads, N), dtype=bf16, device=dev)
    err = _cuda.library().d2s_block_forward(
        x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), mid.data_ptr(),
        hid.data_ptr(), stats.data_ptr(), *ptrs, 0, lse.data_ptr(), cls.data_ptr(),
        0 if policy is None else policy.data_ptr(), 0, 0, B, N, C, heads, hidden,
        float(scale), 1e-6, float(eps), _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_block_forward")
    return qkv, attn, cls, lse[..., 0] if four and policy is None else lse


def _scores(qkv, heads, scale):
    """(B, H, N, N) fp32 scaled scores and (B, H, N, 64) keys of packed qkv."""
    B, N, C3 = qkv.shape
    q, k, _ = qkv.view(B, N, 3, heads, C3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, k


@pytest.mark.parametrize("b", [8, 128])
@pytest.mark.parametrize("eps", [None, 1e-6, 0.1])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 65, 68, 97, 138, 197, 577, 800, 801, 1025])
def test_attention_core_output_cls_rows_and_row_statistics(cuda, n, eps, b):
    """The block's attention core, plain (eps None) and policy mode, on the
    qkv it read: its output and CLS rows against the plain versions, its
    row statistics against the scores' in fp32 (the log-sum-exp; the max,
    the denominator, and one column at the max on rows whose two largest
    scores are apart). B=8 splits each sample-head's query tiles over
    several CTAs, B=128 gives each one CTA. Past 800 tokens the core is
    attention_hd_kernel at width 64."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((b, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    pol = None if eps is None else _policy(gen, b, n, cuda)
    kw = {} if pol is None else {"policy": pol, "eps": eps}
    scale = blk.attn.scale
    with torch.inference_mode():
        qkv, attn, cls, st = _block_core(x, blk.kernel_weights(torch.bfloat16), 6, scale, pol,
                                         1e-6 if eps is None else eps)
        want, want_cls = attention_reference(qkv, 6, scale, return_cls=True, **kw)
        s, _ = _scores(qkv, 6, scale)
        torch.cuda.synchronize()
    _assert_close(attn, want)
    _assert_close(cls, want_cls)
    torch.testing.assert_close(cls.float().sum(-1), torch.ones((b, 6), device=cuda),
                               rtol=0, atol=2e-2)
    if pol is None:
        want_lse = torch.logsumexp(s, -1)
        assert (st - want_lse).abs().max().item() <= 1e-3 * max(1.0, want_lse.abs().max().item())
        return
    m, den, ties = st[..., 0], st[..., 1], st[..., 2]
    top = s.topk(min(2, n), -1).values
    want_m = top[..., 0]
    assert (m - want_m).abs().max().item() <= 1e-5 * want_m.abs().max().item() + 1e-6
    a = pol[:, None, None, :] + (1 - pol[:, None, None, :]) * torch.eye(n, device=cuda)
    want_den = (torch.exp(s - want_m[..., None]) * a).sum(-1) + eps
    torch.testing.assert_close(den, want_den, rtol=1e-3, atol=0)
    apart = top[..., 0] - top[..., -1] > 1e-3 * top[..., 0].abs() if n > 1 else ties == ties
    assert apart.float().mean() > 0.9 and torch.all(ties[apart] == 1)


@pytest.mark.parametrize("n", [197, 138, 97, 68, 13, 1, 384])
@pytest.mark.parametrize("c,heads", [(384, 6), (768, 12)])
def test_block_backward_kernel(cuda, c, heads, n):
    blk = _sharpen(Block(c, heads, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, c), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, n, c), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        dx, dw, none = ops.fused_transformer_block_backward(x, g, w, heads)
        want_dx, want_dw, _ = transformer_block_backward_reference(
            x, g, w, heads, blk.attn.scale, 1e-6)
        torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and none is None
    _assert_close(dx, want_dx, BWD_TOL)
    for k in BLOCK_WEIGHT_KEYS:
        assert dw[k].dtype == torch.float32 and dw[k].shape == w[k].shape, k
        _assert_close(dw[k], want_dw[k], BWD_TOL)


def test_trainable_block_gradients_reach_the_parameters(cuda):
    blk = _sharpen(Block(384, 6, use_fused=True), seed=3).to(cuda).train()
    ref = Block(384, 6, use_fused=False).to(cuda).train()
    ref.load_state_dict(blk.state_dict())
    x = torch.randn((2, 97, 384), device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    blk(x).float().square().sum().backward()
    ref(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block": 1,
                                   "fused_transformer_block_backward": 1, **_norm(blocks=1),
                                   **_core(1)}
    for (name, p), q in zip(blk.named_parameters(), ref.parameters()):
        _assert_close(p.grad, q.grad, BWD_TOL)


# DeiT-S widths at the three stages, DeiT-B's large predictor, whose first
# output unit takes 3072-wide rows, and ViT-H/14's small one at its three
# stages (D = 1280, 256 / 179 / 125 patches)
@pytest.mark.parametrize("d,small,n", [
    (384, True, 196), (384, True, 137), (384, True, 96),
    (384, False, 196), (384, False, 137), (384, False, 96), (768, False, 196),
    (1280, True, 256), (1280, True, 179), (1280, True, 125),
])
def test_predictor_kernel_on_spatial_view(cuda, d, small, n):
    pred = _sharpen(PredictorLG(d, small_predictor=small), seed=n).to(cuda).eval()
    x = torch.randn((4, n + 1, d), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        w = pred.kernel_weights(torch.bfloat16)
        got = ops.fused_predictor_lg(x[:, 1:], w)
        want = predictor_lg_reference(x[:, 1:], w)
        torch.cuda.synchronize()
    _assert_close(got, want)


# B=1 and 3; N whose samples end inside a 64- or 128-row tile (13: up to
# eleven samples in one tile; 61, 150); the large predictor at D=768 with
# its chunked 1536-wide inputs; the small one at ViT-H/14's D=1280
PREDICTOR_CASES = [
    (384, True, 1, 196), (384, True, 3, 137), (384, False, 3, 96), (384, True, 5, 13),
    (384, False, 2, 61), (384, True, 7, 150), (768, False, 3, 50), (768, False, 1, 13),
    (1280, True, 3, 256), (1280, True, 2, 13),
]


@pytest.mark.parametrize("d,small,b,n", PREDICTOR_CASES)
def test_predictor_kernel_against_both_plain_versions(cuda, d, small, b, n):
    """The kernel against the plain version and the plain split form it
    computes, two launches bit-equal, one launch counted per call."""
    pred = _sharpen(PredictorLG(d, small_predictor=small), seed=b * n).to(cuda).eval()
    x = torch.randn((b, n + 1, d), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        w = pred.kernel_weights(torch.bfloat16)
        before = ops.fused_predictor_lg.launches
        got = ops.fused_predictor_lg(x[:, 1:], w)
        again = ops.fused_predictor_lg(x[:, 1:], w)
        torch.cuda.synchronize()
        assert ops.fused_predictor_lg.launches == before + 2
        assert torch.equal(got, again)
        _assert_close(got, predictor_lg_reference(x[:, 1:], w))
        _assert_close(got, predictor_lg_split_reference(x[:, 1:], w))


def _predictor_weights(d, widths, n_in, act, seed, device):
    """PredictorLG weights at any widths, drawn on the CPU: matrices
    N(0, 1/fan_in), LayerNorm scales 1 +- 0.1, biases 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)

    def unit(c_in, c_out):
        return (1 + 0.1 * torch.randn(c_in, generator=g), 0.1 * torch.randn(c_in, generator=g),
                (torch.randn((c_out, c_in), generator=g) / c_in ** 0.5).to(torch.bfloat16),
                0.1 * torch.randn(c_out, generator=g))

    ins = (d, *widths[:-1])
    units = [tuple(t.to(device) for t in unit(a, b)) for a, b in zip(ins, widths)]
    final = tuple(t.to(device) for t in unit(widths[-1], 1))
    return {"units": units, "n_in": n_in, "final": final, "act": act}


# Shapes no model builds that the kernel takes: the split after the last
# unit (the final unit on the concat row), and a split width c = 8 mod 16,
# whose local half c / 2 ends inside an 8-column vector (with and without
# an output unit after it)
@pytest.mark.parametrize("d,widths,n_in,act,b,n", [
    (384, (384, 192, 96), 3, "gelu", 3, 137), (40, (40, 24, 16), 1, "gelu", 5, 13),
    (48, (24, 32, 8), 1, "relu", 2, 61), (40, (40,), 1, "relu", 3, 29),
])
def test_predictor_kernel_takes_a_split_after_the_last_unit_or_inside_a_vector(
        cuda, d, widths, n_in, act, b, n):
    w = _predictor_weights(d, widths, n_in, act, seed=b * n, device=cuda)
    x = torch.randn((b, n + 1, d), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        got = ops.fused_predictor_lg(x[:, 1:], w)
        again = ops.fused_predictor_lg(x[:, 1:], w)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _assert_close(got, predictor_lg_reference(x[:, 1:], w))
        _assert_close(got, predictor_lg_split_reference(x[:, 1:], w))


def test_student_forward_launches_every_kernel(cuda):
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda,
                         **HEADLINE_KWARGS).eval()
    x = torch.randn((2, 224, 224, 3), device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(x, collect_cls_attns=False)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_transformer_block": 12, "fused_predictor_lg": 3,
        "fused_gather_tokens": 3,
    }
    assert out.logits.shape == (2, 1000) and out.features.shape == (2, 67, 384)
    assert int(out.kept_idx_orig.max()) < 196


def test_train_mode_launches_the_kernels_or_raises(cuda):
    """Train mode takes no plain path on the card for the blocks and the
    gather: under autograd the forward launches the block and gather
    kernels and the backward their backward kernels; the predictor runs its
    plain layers in train mode, as in the JAX package. A fused block in
    train mode that captures its CLS rows takes the packed attention and
    the MLP half, a kernel each way."""
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda,
                         **HEADLINE_KWARGS).train()
    x = torch.randn((2, 224, 224, 3), device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    out = model(x, collect_cls_attns=False)
    (out.logits.float().sum() + sum(p.float().sum() for p in out.pred_logits)).backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_transformer_block": 12,
        "fused_transformer_block_backward": 12, "fused_gather_tokens": 3,
        "fused_scatter_tokens": 3, **_norm(blocks=12), **_core(12),
    }
    assert model.blocks[0].attn.qkv.weight.grad is not None
    assert model.score_predictor[0].in_conv[1].weight.grad is not None
    ops.reset_launch_counts()
    y, cls = model.blocks[0](torch.randn((2, 197, 384), device=cuda, dtype=torch.bfloat16),
                             return_cls_attn=True)
    (y.float().sum() + cls.float().sum()).backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_attention_packed": 1, "fused_attention_backward_packed": 1,
        "fused_mlp_residual": 1, "fused_mlp_residual_backward": 1, **_norm(halves=1),
        **_core(1),
    }


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 13, 384), device=cuda)  # fp32: the block kernel is bf16
    blk = Block(384, 6).to(cuda).eval()
    with torch.inference_mode(), pytest.raises(TypeError):
        ops.fused_transformer_block(x, blk.kernel_weights(torch.float32), 6)
    xb = x.to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="not differentiable"):
        ops.fused_transformer_block(xb, blk.kernel_weights(torch.bfloat16), 6)
    # past the ceiling (shared memory), before anything touches the device
    for backward in (False, True):
        n = block_ops.attention_max_tokens(64, backward=backward) + 1
        xn = torch.zeros((1, n, 384), device=cuda, dtype=torch.bfloat16)
        with torch.no_grad(), pytest.raises(ValueError, match=f"the kernels take 1 to {n - 1}"):
            if backward:
                ops.fused_transformer_block_backward(xn, xn, blk.kernel_weights(torch.bfloat16), 6)
            else:
                ops.fused_transformer_block(xn, blk.kernel_weights(torch.bfloat16), 6)


def test_train_step_launches_every_training_kernel(cuda):
    student = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda,
                           **HEADLINE_KWARGS)
    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=True, device=cuda,
                           dtype="bfloat16")
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, steps_per_epoch=10)
    opt.count = cfg.train.warmup_epochs * 10
    step = make_train_step(student, teacher, opt, cfg)
    x = torch.randn((2, 224, 224, 3), device=cuda)
    labels = torch.tensor([3, 7], device=cuda)
    ops.reset_launch_counts()
    metrics = step(x, labels, epoch=cfg.train.warmup_epochs)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_transformer_block": 12, "fused_transformer_block_cls": 12,
        "fused_transformer_block_backward": 12, "fused_gather_tokens": 3,
        "fused_scatter_tokens": 3, **_norm(blocks=12), **_core(12),
    }
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# ---- the block's policy mode ------------------------------------------------


def _policy(gen, b, n, dev):
    pol = (torch.rand((b, n), generator=gen, device=dev) < 0.6).float()
    pol[:, 0] = 1.0
    return pol


@pytest.mark.parametrize("eps", [1e-6, 0.1])
@pytest.mark.parametrize("n", [197, 138, 13, 1, 800, 801, 1025])
def test_policy_block_kernel(cuda, n, eps):
    """The policy-mode forward and its CLS rows against the plain version;
    at N=13 with eps = 0.1 the smoothing is large enough to see in bf16."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, 4, n, cuda)
    with torch.inference_mode():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        got = ops.fused_transformer_block(x, w, 6, pol, eps=eps)
        got_c, cls = ops.fused_transformer_block_cls(x, w, 6, pol.to(torch.bfloat16), eps=eps)
        want, want_cls = transformer_block_reference(
            x, w, 6, blk.attn.scale, 1e-6, policy=pol, eps=eps, return_cls=True)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block[policy]": 1,
                                   "fused_transformer_block_cls": 1,
                                   **chip_smoke.core_launches(forwards=2, n=n)}
    assert torch.equal(got, got_c)
    _assert_close(got, want)
    _assert_close(cls, want_cls)
    torch.testing.assert_close(cls.float().sum(-1), torch.ones((4, 6), device=cuda),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("eps,ties", [(1e-6, False), (0.1, False), (0.1, True)])
@pytest.mark.parametrize("n", [197, 68, 13, 352])
def test_policy_block_backward_kernel(cuda, n, eps, ties):
    """dx, the twelve gradients and dPolicy against the plain version; with
    ties, tokens copied from token 1 give rows whose max is reached at
    several columns (the max path's gradient is split among them)."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    if ties and n > 8:
        x[:, 2:8] = x[:, 1:2]
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, 4, n, cuda)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        dx, dw, dpol = ops.fused_transformer_block_backward(x, g, w, 6, pol, eps=eps)
        dx2, dw2, none = ops.fused_transformer_block_backward(x, g, w, 6, pol, eps=eps,
                                                              policy_grad=False)
        want_dx, want_dw, want_dpol = transformer_block_backward_reference(
            x, g, w, 6, blk.attn.scale, 1e-6, policy=pol, eps=eps)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block_backward[policy]": 2,
                                   **_norm(blocks=2), **_core(2)}
    assert none is None and torch.equal(dx, dx2)
    assert dpol.dtype == torch.float32 and dpol.shape == (4, n)
    _assert_close(dx, want_dx, BWD_TOL)
    _assert_close(dpol, want_dpol, BWD_TOL)
    for k in BLOCK_WEIGHT_KEYS:
        _assert_close(dw[k], want_dw[k], BWD_TOL)
        assert torch.equal(dw[k], dw2[k]), k


@pytest.mark.parametrize("n", [197, 352, 800, 801, 1025])
def test_policy_block_on_planted_exact_ties(cuda, n):
    """The token most often at a row's max copied to five more positions
    (chip_smoke.planted_ties): rows whose max is that group reach it at six
    bit-identical keys. The forward's stored tie count, which the policy
    backward's max path divides by, must count exactly the columns whose
    keys equal the max's (the backward finds them by comparing its own
    recomputed scores with the stored max, so the forward's scores must be
    its bits); and dx, the gradients and dPolicy against the plain version
    on that input (N = 800 on the backward's long path; past it on the
    attention_hd pair at width 64, whose scores are one instruction's both
    ways)."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, 4, n, cuda)
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    scale = blk.attn.scale
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        x, tied = chip_smoke.planted_ties(torch, x, w, 6, scale, 1e-6)
        qkv, _, _, st = _block_core(x, w, 6, scale, pol, 0.1)
        s, k = _scores(qkv, 6, scale)
        # the columns whose key is bit for bit the key at the row's max
        _, ids = torch.unique(k.contiguous().view(torch.int16).reshape(-1, 64), dim=0,
                              return_inverse=True)
        ids = ids.view(4, 6, 1, n)
        at_max = ids.gather(-1, s.argmax(-1)[..., None].transpose(-1, -2)).transpose(-1, -2)
        want_ties = (ids == at_max).sum(-1).float()
        # rows whose max group stands clear of every other column
        other = torch.where(ids == at_max, torch.full_like(s, -torch.inf), s).amax(-1)
        top = s.amax(-1)
        clear = top - other > 1e-3 * top.abs()
        torch.cuda.synchronize()
    assert tied > 0 and bool(((want_ties == 6) & clear).any())
    assert torch.equal(st[..., 2][clear], want_ties[clear])
    with torch.no_grad():
        dx, dw, dpol = ops.fused_transformer_block_backward(x, g, w, 6, pol, eps=0.1)
        want_dx, want_dw, want_dpol = transformer_block_backward_reference(
            x, g, w, 6, scale, 1e-6, policy=pol, eps=0.1)
        torch.cuda.synchronize()
    _assert_close(dx, want_dx, BWD_TOL)
    _assert_close(dpol, want_dpol, BWD_TOL)
    for key in BLOCK_WEIGHT_KEYS:
        _assert_close(dw[key], want_dw[key], BWD_TOL)


def test_policy_trainable_block_returns_dpolicy_in_its_dtype(cuda):
    blk = _sharpen(Block(384, 6, use_fused=True), seed=5).to(cuda).train()
    x = torch.randn((2, 197, 384), device=cuda).to(torch.bfloat16)
    pol = _policy(torch.Generator(device=cuda).manual_seed(5), 2, 197, cuda)
    pol = pol.to(torch.bfloat16).requires_grad_()
    ops.reset_launch_counts()
    blk(x, pol).float().square().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block[policy]": 1,
                                   "fused_transformer_block_backward[policy]": 1,
                                   **_norm(blocks=1), **_core(1)}
    assert pol.grad.dtype == torch.bfloat16 and torch.isfinite(pol.grad.float()).all()


# ---- the int8 block, the custom ops and export ------------------------------


def _int8_block(seed, c=384, heads=6):
    return _sharpen(Block(c, heads, use_fused=True, quant="int8"), seed=seed)


@pytest.mark.parametrize("n", [13, 68, 197])
@pytest.mark.parametrize("c,heads", [(384, 6), (768, 12), (1280, 16), (2048, 16)])
def test_int8_block_kernel(cuda, c, heads, n):
    """The W8A8 block against its plain version on the same codes: the
    attention output's and the activation's codes are bit-equal (the same
    bf16 rows divided by the same scales); the whole output within TOL (the
    attention cores and LayerNorms round differently). DeiT-S and DeiT-B
    widths (fc2's K up to 3072), ViT-H/14's (hidden 5120) and a 2048-wide
    block's (hidden 8192): rows past 4096 on the CTA-a-row quantizer."""
    blk = _int8_block(n, c, heads).to(cuda).eval()
    x = torch.randn((4, n, c), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        qw = blk.int8_weights(torch.bfloat16)
        before = ops.fused_transformer_block_int8.launches
        got, st = ops.fused_transformer_block_int8(x, qw, heads, stages=True)
        want = quant_block_reference(x, qw, heads, blk.attn.scale, 1e-6)
        torch.cuda.synchronize()
        assert ops.fused_transformer_block_int8.launches == before + 1
        for i, h in ((2, st["attn"]), (4, st["act"])):
            q, s = quantize_rows(h.float())
            assert torch.equal(st[f"q{i}"], q) and torch.equal(st[f"s{i}"], s[..., 0]), i
    _assert_close(got, want)


def _op_inputs(n=13):
    """Small inputs and weights for every serving op, on the CPU."""
    blk = _int8_block(seed=3).eval()
    pred = _sharpen(PredictorLG(384, small_predictor=True), seed=4).eval()
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, n, 384), generator=g).to(torch.bfloat16)
    idx = torch.randint(0, n, (2, 7), generator=g)
    pol = (torch.rand((2, n), generator=g) < 0.6).float()
    pol[:, 0] = 1.0
    return blk, pred, x, idx, pol


def test_custom_ops_cuda_against_cpu(cuda):
    """Each d2s:: op's CUDA implementation (the kernel) against its CPU
    implementation (the plain version) on the same bf16 inputs."""
    inputs = _op_inputs()
    with torch.inference_mode():
        outs = {}
        for dev in (cuda, torch.device("cpu")):
            blk, pred, x, idx, pol = (copy.deepcopy(t).to(dev) for t in inputs)
            w = blk.kernel_weights(torch.bfloat16)
            outs[dev.type] = {
                "block": ops.fused_transformer_block(x, w, 6),
                "policy": ops.fused_transformer_block(x, w, 6, pol),
                "cls": ops.fused_transformer_block_cls(x, w, 6)[1],
                "int8": ops.fused_transformer_block_int8(x, blk.int8_weights(torch.bfloat16), 6),
                "predictor": ops.fused_predictor_lg(x[:, 1:], pred.kernel_weights(torch.bfloat16)),
                "gather": ops.fused_gather_tokens(x, idx),
            }
        torch.cuda.synchronize()
    for k, got in outs["cuda"].items():
        got, want = got.cpu().float(), outs["cpu"][k].float()
        err = (got - want).abs().max().item()
        assert err <= TOL * want.abs().max().item(), (k, err)
    assert torch.equal(outs["cuda"]["gather"].cpu(), outs["cpu"]["gather"])


def test_int8_students_launch_the_int8_kernel_in_eval_only(cuda):
    """Top-k: 12 int8 blocks, 3 predictors, 3 gathers; threshold: 3 int8 and
    9 bf16 policy blocks; the teacher built with quant='int8' and the
    students in train mode never launch the int8 kernel."""
    x = torch.randn((2, 224, 224, 3), device=cuda, dtype=torch.bfloat16)
    int8 = dict(HEADLINE_KWARGS, quant="int8", use_fused_attention=True)
    topk = create_model(HEADLINE_MODEL, device=cuda, **int8).eval()
    thr = create_model(HEADLINE_MODEL, device=cuda, patch_score_threshold=0.5, **int8).eval()
    teacher = create_model(HEADLINE_TEACHER, device=cuda, dtype="bfloat16", quant="int8",
                           use_fused_attention=True).eval()
    for model, want in (
        (topk, {"fused_transformer_block_int8": 12, "fused_predictor_lg": 3,
                "fused_gather_tokens": 3}),
        (thr, {"fused_transformer_block_int8": 3, "fused_transformer_block[policy]": 9,
               "fused_predictor_lg": 3}),
        (teacher, {"fused_transformer_block_cls": 12}),
    ):
        ops.reset_launch_counts()
        kw = {} if model is teacher else {"collect_cls_attns": False}
        with torch.inference_mode():
            logits = model(x, **kw)
            logits = logits.logits if hasattr(logits, "logits") else logits[0]
            torch.cuda.synchronize()
        assert ops.launch_counts() == {**NO_LAUNCHES, **want}
        assert torch.isfinite(logits.float()).all()
    ops.reset_launch_counts()
    topk.train()(x, collect_cls_attns=False).logits.float().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_transformer_block_int8"] == 0
    assert ops.launch_counts()["fused_transformer_block"] == 12


def test_exported_int8_student_serves_on_the_card(cuda):
    """A symbolic-batch artifact of the int8 headline student, loaded back:
    the live model's logits bit for bit and its launches, at two batch
    sizes."""
    model = create_model(HEADLINE_MODEL, device=cuda, quant="int8", use_fused_attention=True,
                         **HEADLINE_KWARGS).eval()
    fn = load_exported(export_student(model))
    for b in (1, 3):
        x = torch.randn((b, 224, 224, 3), device=cuda)
        with torch.inference_mode():
            ops.reset_launch_counts()
            want = model(x.to(torch.bfloat16), collect_cls_attns=False).logits.float()
            live = ops.launch_counts()
            ops.reset_launch_counts()
            got = fn(x)
            torch.cuda.synchronize()
        assert ops.launch_counts() == live
        assert torch.equal(got, want)


# ---- the packed attention and the MLP half (a training block's CLS capture) --


def _thirds_close(got, want, tol=BWD_TOL):
    """q, k and v of a packed dqkv apart: a fault in dQ or dK would hide
    under dV."""
    for a, b in zip(got.chunk(3, -1), want.chunk(3, -1)):
        _assert_close(a, b, tol)


@pytest.mark.parametrize("policy,n", [(False, 13), (False, 197), (True, 197), (True, 352)])
@pytest.mark.parametrize("with_gcls", [False, True])
def test_packed_attention_both_ways(cuda, n, policy, with_gcls):
    """The packed forward (output, CLS rows) and backward (dqkv, and dPolicy
    in policy mode, at eps 0.1) against the plain versions, on qkv that is a
    strided view (the first 3C channels of wider rows), with and without
    the CLS rows' cotangent."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    bf16 = torch.bfloat16
    wide = torch.randn((4, n, 4 * 384), generator=gen, device=cuda).to(bf16)
    qkv = wide[..., :3 * 384]
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(bf16)
    gcls = torch.randn((4, 6, n), generator=gen, device=cuda) if with_gcls else None
    pol = _policy(gen, 4, n, cuda) if policy else None
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    scale = 64 ** -0.5
    with torch.no_grad():
        ops.reset_launch_counts()
        out, cls = ops.fused_attention_packed(qkv, 6, pol, scale=scale, eps=0.1, return_cls=True)
        res = ops.fused_attention_backward_packed(qkv, g, 6, gcls=gcls, scale=scale, **kw)
        torch.cuda.synchronize()
        want_out, want_cls = attention_reference(qkv, 6, scale, return_cls=True, **kw)
        want_dqkv, want_dpol = attention_backward_reference(qkv, g, 6, scale, gcls=gcls, **kw)
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_attention_packed": 1,
                                   "fused_attention_backward_packed": 1, **_core(1)}
    _assert_close(out, want_out)
    _assert_close(cls, want_cls)
    dqkv, dpol = res if policy else (res, None)
    _thirds_close(dqkv, want_dqkv)
    if policy:
        _assert_close(dpol, want_dpol, BWD_TOL)
    if with_gcls:  # the fold alone
        zero = torch.zeros_like(g)
        with torch.no_grad():
            res = ops.fused_attention_backward_packed(qkv, zero, 6, gcls=gcls, scale=scale, **kw)
            want, _ = attention_backward_reference(qkv, zero, 6, scale, gcls=gcls, **kw)
        _thirds_close(res[0] if policy else res, want)


@pytest.mark.parametrize("n", [13, 197])
def test_mlp_residual_both_ways(cuda, n):
    """The MLP half's output and its seven cotangents against the plain
    versions; the Function's gradients are the backward kernel's."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    kw = blk.kernel_weights(torch.bfloat16)
    w = [kw[k].detach() for k in ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")]
    with torch.no_grad():
        ops.reset_launch_counts()
        y = ops.fused_mlp_residual(x, *w, 1e-6)
        grads = ops.fused_mlp_residual_backward(x, g, *w[:5])
        torch.cuda.synchronize()
        assert ops.launch_counts() == {**NO_LAUNCHES, "fused_mlp_residual": 1,
                                       "fused_mlp_residual_backward": 1, **_norm(halves=1)}
        _assert_close(y, mlp_residual_reference(x, *w, 1e-6))
        for a, b in zip(grads, mlp_residual_backward_reference(x, g, *w[:5], 1e-6)):
            _assert_close(a, b, BWD_TOL)
    leaves = [t.clone().requires_grad_() for t in [x] + w]
    ops.fused_mlp_residual(*leaves, 1e-6).backward(g)
    for a, b in zip(leaves, grads):
        assert torch.equal(a.grad, b.to(a.dtype))


def test_attn_student_train_step_launches(cuda):
    """One train step of the attn-selection student: the teacher's 12
    CLS-row blocks; the student's 12 packed cores and MLP halves each way, 3
    gathers and 3 scatters; no whole-block kernel and no predictor."""
    from dense2sparse_vit_torch.models import ATTN_KWARGS

    student = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda, **ATTN_KWARGS)
    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=True, device=cuda,
                           dtype="bfloat16")
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, steps_per_epoch=10)
    opt.count = cfg.train.warmup_epochs * 10
    step = make_train_step(student, teacher, opt, cfg)
    x = torch.randn((2, 224, 224, 3), device=cuda)
    ops.reset_launch_counts()
    metrics = step(x, torch.tensor([3, 7], device=cuda), epoch=cfg.train.warmup_epochs + 1)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_attention_packed": 12,
        "fused_attention_backward_packed": 12, "fused_mlp_residual": 12,
        "fused_mlp_residual_backward": 12, "fused_gather_tokens": 3, "fused_scatter_tokens": 3,
        **_norm(halves=12), **_core(12),
    }
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# ---- DropPath branch scales: the T2T-ViT-14 block (C 384, hidden 1152, no
# qkv bias) with per-sample scales in {0, 1/keep} ------------------------------

KEEP = 0.7
SA = [0.0, 1 / KEEP, 1 / KEEP, 0.0]
SM = [1 / KEEP, 0.0, 1 / KEEP, 0.0]


def _t2t_block_case(cuda, n, policy):
    blk = _sharpen(Block(384, 6, mlp_ratio=3.0, qkv_bias=False, layer_norm_eps=1e-5,
                         use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(torch.bfloat16)
    pol = None
    if policy:
        pol = (torch.rand((4, n), generator=gen, device=cuda) < 0.6).float()
        pol[:, 0] = 1.0
    scales = (torch.tensor(SA, device=cuda), torch.tensor(SM, device=cuda))
    return blk, x, g, pol, scales


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("n", [197, 138, 97, 68, 13])
def test_scaled_block_kernels_both_ways(cuda, n, policy):
    blk, x, g, pol, scales = _t2t_block_case(cuda, n, policy)
    kw = dict(scale=blk.attn.scale, ln_eps=1e-5)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        got = ops.fused_transformer_block(x, w, 6, pol, branch_scales=scales, **kw)
        dx, dw, dpol = ops.fused_transformer_block_backward(x, g, w, 6, pol,
                                                            branch_scales=scales, **kw)
        torch.cuda.synchronize()
        assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block[scaled]": 1,
                                       "fused_transformer_block_backward[scaled]": 1,
                                       **_norm(blocks=1), **_core(1)}
        want = transformer_block_reference(x, w, 6, blk.attn.scale, 1e-5, policy=pol,
                                           branch_scales=scales)
        want_dx, want_dw, want_dpol = transformer_block_backward_reference(
            x, g, w, 6, blk.attn.scale, 1e-5, policy=pol, branch_scales=scales)
    _assert_close(got, want)
    _assert_close(dx, want_dx, BWD_TOL)
    for k in BLOCK_WEIGHT_KEYS:
        if w[k] is not None:
            _assert_close(dw[k], want_dw[k], BWD_TOL)
    if policy:
        _assert_close(dpol, want_dpol, BWD_TOL)
    # sample 3 drops both branches: the block passes its input through
    assert torch.equal(got[3], x[3])


@pytest.mark.parametrize("policy", [False, True])
def test_scales_of_one_are_the_unscaled_kernels_bit_for_bit(cuda, policy):
    """Scales of one multiply exactly, so the scaled kernels reproduce the
    unscaled ones (null scales: no multiply) bit for bit, both ways."""
    blk, x, g, pol, _ = _t2t_block_case(cuda, 197, policy)
    ones = (torch.ones(4, device=cuda),) * 2
    kw = dict(scale=blk.attn.scale, ln_eps=1e-5)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        assert torch.equal(ops.fused_transformer_block(x, w, 6, pol, **kw),
                           ops.fused_transformer_block(x, w, 6, pol, branch_scales=ones, **kw))
        a = ops.fused_transformer_block_backward(x, g, w, 6, pol, **kw)
        b = ops.fused_transformer_block_backward(x, g, w, 6, pol, branch_scales=ones, **kw)
        torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and (a[2] is None or torch.equal(a[2], b[2]))
    assert all(a[1][k] is None or torch.equal(a[1][k], b[1][k]) for k in BLOCK_WEIGHT_KEYS)


def test_drop_path_block_trains_through_the_scaled_kernels(cuda):
    """A fused training Block at drop path 0.4 takes the scaled kernels each
    way and gives the plain Block's gradients from the same generator seed."""
    blk = _sharpen(Block(384, 6, mlp_ratio=3.0, qkv_bias=False, drop_path=0.4,
                         use_fused=True), seed=4).to(cuda).train()
    ref = Block(384, 6, mlp_ratio=3.0, qkv_bias=False, drop_path=0.4).to(cuda).train()
    ref.load_state_dict(blk.state_dict())
    x = torch.randn((8, 97, 384), device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    blk(x, generator=torch.Generator(device=cuda).manual_seed(1)).float().square().sum().backward()
    ref(x, generator=torch.Generator(device=cuda).manual_seed(1)).float().square().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block[scaled]": 1,
                                   "fused_transformer_block_backward[scaled]": 1,
                                   **_norm(blocks=1), **_core(1)}
    for p, q in zip(blk.parameters(), ref.parameters()):
        _assert_close(p.grad, q.grad, BWD_TOL)


def test_t2t_student_train_step_launches(cuda):
    """One train step of the pruned T2T-ViT-14 at drop path 0.1 with its
    teacher: 14 CLS-row teacher blocks; the student's block 0 plain and
    blocks 1-13 scaled, each way; 3 gathers and 3 scatters."""
    from dense2sparse_vit_torch.models import T2T_KWARGS, T2T_MODEL, ViTTeacher

    student = create_model(T2T_MODEL, device=cuda, drop_path_rate=0.1, **T2T_KWARGS)
    teacher = ViTTeacher(student.cfg).init_weights(torch.Generator().manual_seed(2)).to(cuda)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, steps_per_epoch=10)
    opt.count = cfg.train.warmup_epochs * 10
    step = make_train_step(student, teacher, opt, cfg)
    x = torch.randn((2, 224, 224, 3), device=cuda)
    ops.reset_launch_counts()
    metrics = step(x, torch.tensor([3, 7], device=cuda), epoch=cfg.train.warmup_epochs + 1)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {
        **NO_LAUNCHES, "fused_transformer_block_cls": 14, "fused_transformer_block": 1,
        "fused_transformer_block[scaled]": 13, "fused_transformer_block_backward": 1,
        "fused_transformer_block_backward[scaled]": 13, "fused_gather_tokens": 3,
        "fused_scatter_tokens": 3, **_norm(blocks=14), **_core(14),
    }
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# ---- the attention half-block and its inference variants -----------------------


HALF_BLOCK_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")


def _half_block(cuda, seed, c=384, heads=6):
    """A sharpened block's LN1, qkv and proj weights, as the half-block takes
    them, and its softmax scale."""
    blk = _sharpen(Block(c, heads, use_fused=True), seed=seed).to(cuda).eval()
    w = blk.kernel_weights(torch.bfloat16)
    return [w[k] for k in HALF_BLOCK_KEYS], blk.attn.scale


@pytest.mark.parametrize("policy,n", [(False, 13), (False, 197), (False, 384), (True, 197),
                                      (True, 352)])
def test_attention_block_both_ways(cuda, n, policy):
    """The half-block forward (output, its attention core, the CLS rows) and
    backward (dx, the six gradients, qkv's thirds apart, and dPolicy at eps
    0.1 in policy mode) against the plain versions."""
    w6, scale = _half_block(cuda, n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    bf16 = torch.bfloat16
    x = torch.randn((4, n, 384), generator=gen, device=cuda).to(bf16)
    g = torch.randn((4, n, 384), generator=gen, device=cuda).to(bf16)
    pol = _policy(gen, 4, n, cuda) if policy else None
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        ops.reset_launch_counts()
        out, cls, st = ops.fused_attention_block(x, *w6, 6, return_cls=True, stages=True, **kw)
        if policy:
            dx, dpol, *grads = ops.fused_attention_block_backward_policy(x, g, pol, *w6[:5], 6,
                                                                         eps=0.1)
        else:
            dx, *grads = ops.fused_attention_block_backward(x, g, *w6[:5], 6)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want_out, want_cls = attention_block_reference(x, *w6, 6, return_cls=True, **kw)
        want_core = attention_reference(st["qkv"], 6, scale, **kw)
        want_dx, want_dw, want_dpol = attention_block_backward_reference(x, g, *w6[:5], 6, **kw)
    bwd = "attention_block_backward" + ("_policy" if policy else "")
    assert counts == {**NO_LAUNCHES, "attention_block_forward": 1, bwd: 1, **_norm(halves=1),
                      **_core(1)}
    _assert_close(out, want_out)
    _assert_close(st["attn"], want_core)
    _assert_close(cls, want_cls)
    _assert_close(dx, want_dx, BWD_TOL)
    for k, got in zip(ATTN_BLOCK_KEYS, grads):
        _assert_close(got, want_dw[k], BWD_TOL)
    _thirds_close(grads[2].t(), want_dw["wqkv"].t())
    if policy:
        _assert_close(dpol, want_dpol, BWD_TOL)


def test_trainable_attention_block_launches_and_returns_dpolicy(cuda):
    """The autograd Function: one forward and one backward launch per mode,
    its gradients those of the backward kernel in each input's dtype,
    dPolicy in the policy's."""
    w6, _ = _half_block(cuda, 5)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4, 68, 384), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=cuda).to(x.dtype)
    pol = _policy(gen, 4, 68, cuda).to(torch.bfloat16).requires_grad_()
    leaves = [t.detach().clone().requires_grad_() for t in (x, *w6)]
    ops.reset_launch_counts()
    out = ops.fused_attention_block_trainable(leaves[0], *leaves[1:], 6)
    grads = torch.autograd.grad(out, leaves, g)
    out = ops.fused_attention_block_trainable(leaves[0], *leaves[1:], 6, pol)
    grads_p = torch.autograd.grad(out, leaves + [pol], g)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "attention_block_forward": 2,
                                   "attention_block_backward": 1,
                                   "attention_block_backward_policy": 1, **_norm(halves=2),
                                   **_core(2)}
    with torch.no_grad():
        want = ops.fused_attention_block_backward(x, g, *w6[:5], 6)
    for got, w in zip(grads, want[:6]):
        torch.testing.assert_close(got, w.to(got.dtype), rtol=0, atol=0)
    assert grads_p[-1].dtype == torch.bfloat16 and grads_p[-1].shape == (4, 68)


@pytest.mark.parametrize("variant", [1, 2, 3])
@pytest.mark.parametrize("n", [13, 68, 197, 200])
def test_attention_variant_against_v0_and_plain(cuda, n, variant):
    """Each variant's half-block, its attention core against v0's (the
    shipped kernel) and its output against v0's and its plain version's."""
    from dense2sparse_vit_torch.scripts import attn_variants

    params = attn_variants.make_params(384, cuda)
    x = attn_variants.make_input(4, n, 384, cuda)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out, st = ops.fused_attention_variant(variant, x, *params, 6, stages=True)
        base, base_st = ops.fused_attention_block(x, *params, 6, stages=True)
        torch.cuda.synchronize()
        want = attention_variant_reference(variant, x, *params, 6)
    assert ops.launch_counts() == {**NO_LAUNCHES, "attention_variant": 1,
                                   "attention_block_forward": 1}
    _assert_close(st["attn"], base_st["attn"])
    _assert_close(out, base)
    _assert_close(out, want)


def test_paired_variant_runs_an_odd_last_head_alone(cuda):
    """v2 at 5 heads: two pairs, and head 4 on v1's kernel."""
    w6, scale = _half_block(cuda, 7, c=320, heads=5)
    x = torch.randn((2, 97, 320), generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        out, st = ops.fused_attention_variant(2, x, *w6, 5, stages=True)
        _assert_close(st["attn"], attention_reference(st["qkv"], 5, scale))


def test_two_phase_variant_refuses_what_does_not_fit(cuda):
    """v3 stages its scores in a workspace where they outgrow a CTA: it takes
    N = 800 at 6 heads and N = 197 at 12 (against its plain version); it
    still refuses a head of 128 and a token past the ceiling."""
    from dense2sparse_vit_torch.ops.attention import attention_variant_supported
    from dense2sparse_vit_torch.ops.block import attention_max_tokens

    assert attention_variant_supported(3, 800, 6, 64)
    assert attention_variant_supported(3, 197, 12, 64)
    limit = attention_max_tokens(64)
    assert not attention_variant_supported(3, limit + 1, 6, 64)
    assert not attention_variant_supported(3, 197, 2, 128)
    for c, heads, n in ((384, 6, 800), (768, 12, 197)):
        w6, scale = _half_block(cuda, 8, c=c, heads=heads)
        x = torch.randn((2, n, c), generator=torch.Generator(device=cuda).manual_seed(n),
                        device=cuda).to(torch.bfloat16)
        with torch.inference_mode():
            out, st = ops.fused_attention_variant(3, x, *w6, heads, stages=True)
            _assert_close(st["attn"], attention_reference(st["qkv"], heads, scale))
            _assert_close(out, attention_variant_reference(3, x, *w6, heads))
    w6, _ = _half_block(cuda, 8)
    x = torch.zeros((1, limit + 1, 384), device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode(), pytest.raises(ValueError, match="v3 at"):
        ops.fused_attention_variant(3, x, *w6, 6)
    w2, _ = _half_block(cuda, 8, c=256, heads=2)
    x = torch.zeros((1, 13, 256), device=cuda, dtype=torch.bfloat16)
    with torch.inference_mode(), pytest.raises(ValueError, match="1 to 127"):
        ops.fused_attention_variant(3, x, *w2, 2)


@pytest.mark.parametrize("row,d,heads,b,n", chip_smoke.VARIANT_GEOMETRIES)
def test_attention_variant_widths_against_plain(cuda, row, d, heads, b, n):
    """chip_smoke.py phase 43's geometries at B <= 2: each variant JAX admits
    there, one launch (on the padded route exactly where C % 8 != 0), its
    attention core and output against its plain version and against v0."""
    from dense2sparse_vit_torch.ops import rowpad

    c = d * heads
    w = chip_smoke.hd_block(torch, cuda, c, heads, seed=c + n)
    w6 = [w[k] for k in HALF_BLOCK_KEYS]
    x = torch.randn((min(b, 2), n, c), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        base, base_st = ops.fused_attention_block(x, *w6, heads, stages=True)
        for v in chip_smoke.variant_ids(heads):
            ops.reset_launch_counts()
            rowpad.reset()
            out, st = ops.fused_attention_variant(v, x, *w6, heads, stages=True)
            torch.cuda.synchronize()
            assert ops.launch_counts() == {**NO_LAUNCHES, "attention_variant": 1}
            assert rowpad.counts() == ({"fused_attention_variant": 1} if c % 8 else {})
            core = (paired_attention_reference if v == 2 else attention_reference)(
                st["qkv"], heads, d ** -0.5)
            _assert_close(st["attn"], core)
            _assert_close(out, attention_variant_reference(v, x, *w6, heads))
            _assert_close(st["attn"], base_st["attn"])
            _assert_close(out, base)


# ---- the shared GEMM engine (csrc/ln_gemm.cuh) alone -----------------------

# the products the block kernels give the engine, as chip_smoke.py's phase 28
# times them: (name, N, K, epilogue options), the forward's in the (N, K)
# weight layout, the backward's dX products in the (K, N) layout
GEMM_PRODUCTS = {name: (n, k, opts, kn) for kn, table in ((False, chip_smoke.GEMM_FWD),
                                                          (True, chip_smoke.GEMM_DX))
                 for name, n, k, opts in table}
GEMM_TOL = chip_smoke.GEMM_TOL  # one bf16 rounding of the output and the LayerNorm's


def _gemm_check(a, w, kn, kw):
    got = gemm_ops.ln_gemm(a, w, w_kn=kn, **kw)
    want = gemm_ops.ln_gemm_reference(a, w, w_kn=kn, **kw)
    torch.cuda.synchronize()
    if kw.get("preact"):
        (got, got_pre), (want, want_pre) = got, want
        _assert_close(got_pre, want_pre, GEMM_TOL)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_close(got, want, GEMM_TOL)


@pytest.mark.parametrize("what", sorted(GEMM_PRODUCTS))
@pytest.mark.parametrize("m", [1, 63, 65, 25216, 50432])
def test_ln_gemm_at_the_block_products_shapes(cuda, m, what):
    n, k, opts, kn = GEMM_PRODUCTS[what]
    gen = torch.Generator(device=cuda).manual_seed(m)
    a, w, kw, _ = chip_smoke.gemm_inputs(torch, gen, m, n, k, kn, opts)
    _gemm_check(a, w, kn, kw)


@pytest.mark.parametrize("kn", [False, True])
@pytest.mark.parametrize("opts", [("ln", "bias"), ("bias", "residual", "row_scale"),
                                  ("ln", "bias", "gelu", "preact"), ("gelu_in",),
                                  ("out_f32",), ("bias", "relu")])
def test_ln_gemm_every_epilogue_option_in_both_layouts(cuda, opts, kn):
    gen = torch.Generator(device=cuda).manual_seed(7)
    a, w, kw, _ = chip_smoke.gemm_inputs(torch, gen, 8 * 197, 384, 384, kn, opts)
    _gemm_check(a, w, kn, kw)


@pytest.mark.parametrize("b,n,d,width,act", [(256, 197, 384, 384, "gelu"), (8, 197, 384, 192, "gelu"),
                                              (3, 97, 96, 96, "relu"), (1, 69, 384, 96, "gelu")])
def test_ln_gemm_on_a_strided_view(cuda, b, n, d, width, act):
    """The predictor's first unit reads the spatial tokens x[:, 1:] in place:
    (n - 1) rows per sample, samples n * d apart, never a multiple of the
    tile's 128 rows; ragged K = 96 too."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((b, n, d), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((width, d), generator=gen, device=cuda) / d ** 0.5).to(torch.bfloat16)
    ln = (torch.ones(d, device=cuda), torch.zeros(d, device=cuda), 1e-5)
    kw = {"ln": ln, "bias": torch.randn(width, generator=gen, device=cuda), "act": act}
    xs = x[:, 1:]
    assert xs.is_contiguous() == (b == 1)
    _gemm_check(xs, w, False, kw)


@pytest.mark.parametrize("i,j", [(384, 1536), (1536, 384), (384, 384), (1152, 384)])
@pytest.mark.parametrize("m", [1, 63, 65, 25216])
def test_weight_grad_against_fp32(cuda, m, i, j):
    gen = torch.Generator(device=cuda).manual_seed(m + i)
    p = torch.randn((m, i), generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn((m, j), generator=gen, device=cuda).to(torch.bfloat16)
    got = gemm_ops.weight_grad(p, q)
    want = p.float().t() @ q.float()
    torch.cuda.synchronize()
    # bf16 products summed in fp32 on both sides, in other orders
    _assert_close(got, want, 1e-4)


def test_gemm_runs_give_equal_bits(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    a, w, kw, _ = chip_smoke.gemm_inputs(torch, gen, 25216, 1536, 384, False,
                                         ("ln", "bias", "gelu", "preact"))
    first = gemm_ops.ln_gemm(a, w, **kw)
    second = gemm_ops.ln_gemm(a, w, **kw)
    p, q = a, first[0]
    dw1, dw2 = gemm_ops.weight_grad(p, q), gemm_ops.weight_grad(p, q)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    assert torch.equal(dw1, dw2)


@pytest.mark.parametrize("policy", [False, True])
def test_backward_recomputes_the_forwards_qkv_bit_for_bit(cuda, policy, monkeypatch):
    """The policy backward finds a row's ties by comparing recomputed scores
    with the max the forward stored, so step 1 of d2s_block_backward must
    give the forward's qkv bits: read from the first region of its scratch."""
    B, N, C = 16, 197, 384
    blk = _sharpen(Block(C, 6, use_fused=True), seed=5).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((B, N, C), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((B, N, C), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, B, N, cuda) if policy else None
    scratch = []
    empty = torch.empty

    def spy(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.dtype == torch.uint8:
            scratch.append(t)
        return t

    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        _, st = ops.fused_transformer_block(x, w, 6, pol, stages=True)
        monkeypatch.setattr(torch, "empty", spy)
        ops.fused_transformer_block_backward(x, g, w, 6, pol)
        monkeypatch.setattr(torch, "empty", empty)
        torch.cuda.synchronize()
    recomputed = scratch[0][: B * N * 3 * C * 2].view(torch.bfloat16).view(B, N, 3 * C)
    assert torch.equal(recomputed, st["qkv"])


def test_ln_gemm_refuses_what_the_engine_does_not_take(cuda):
    """K and N that are no multiples of 8 (380, 377) are taken, padded with
    zero columns (`ops.rowpad`; the LayerNorm over the true K), within
    GEMM_TOL of the plain version; a float `a` is refused, and so are
    arguments the C entry does not take."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((64, 384), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((384, 384), generator=gen, device=cuda) / 20).to(torch.bfloat16)
    ln = (1 + torch.randn(380, generator=gen, device=cuda) / 10,
          torch.randn(380, generator=gen, device=cuda) / 10, 1e-6)
    for kw in ({}, {"ln": ln}):
        got = gemm_ops.ln_gemm(a[:, :380], w[:377, :380], **kw)
        want = gemm_ops.ln_gemm_reference(a[:, :380], w[:377, :380], **kw)
        err, ref = chip_smoke.rel_err(torch, got, want)
        assert got.shape == (64, 377) and err <= chip_smoke.GEMM_TOL * ref
    with pytest.raises(TypeError):
        gemm_ops.ln_gemm(a.float(), w)
    # the C entry itself: no output, or M not a whole number of samples
    lib = _cuda.library()
    stream = _cuda.stream_handle(cuda)
    args = [a.data_ptr(), 64, 0, w.data_ptr(), 0, 0, 0, 0, 0.0, 0, 0, 0, 0, 0, 0, 0]
    assert lib.d2s_ln_gemm(*args, 0, 0, 64, 384, 384, 0, stream) != 0
    args[1] = 60
    assert lib.d2s_ln_gemm(*args, a.data_ptr(), 0, 64, 384, 384, 0, stream) != 0


# ---- the int8 products on the engine (ops.quant.qgemm, csrc/ln_gemm.cuh) ----

# the int8 block's four products at DeiT-S's, DeiT-B's and ViT-H's widths
# (C = 384, 768, 1280): (N, K, options), K = C for qkv, proj and fc1, 4C for
# fc2 (5120 at ViT-H)
QGEMM_PRODUCTS = {f"{name}_{c}": (n * c // 384, k * c // 384, opts)
                  for c in (384, 768, 1280) for name, n, k, opts in chip_smoke.QGEMM_FWD}


def _qgemm_check(a, row_s, w, col_s, kw):
    """The kernel bit-equal to its plain version; through GELU (erf in the
    kernel and in torch) within one bf16 rounding, as check_int8_block."""
    got = quant_ops.qgemm(a, row_s, w, col_s, **kw)
    want = quant_ops.qgemm_reference(a, row_s, w, col_s, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if kw["gelu"]:
        assert chip_smoke.ulp_excess(got, want) <= chip_smoke.INT8_ULP_TOL
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("what", sorted(QGEMM_PRODUCTS))
@pytest.mark.parametrize("m", [1, 52, 129, 25216, 50432])
def test_qgemm_at_the_int8_blocks_products_shapes(cuda, m, what):
    n, k, opts = QGEMM_PRODUCTS[what]
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a, row_s, w, col_s, kw, _ = chip_smoke.qgemm_inputs(torch, gen, m, n, k, opts)
    before = quant_ops.qgemm.launches
    _qgemm_check(a, row_s, w, col_s, kw)
    assert quant_ops.qgemm.launches == before + 1


@pytest.mark.parametrize("m,n,k,opts", [(300, 200, 48, ()), (77, 8, 16, ("bias",)),
                                        (1000, 136, 400, ("gelu", "residual")),
                                        (129, 256, 3072, ("residual_f32", "out_f32")),
                                        (64, 384, 1536, ("bias", "gelu", "residual_f32")),
                                        (513, 1152, 384, ("bias", "residual", "out_f32"))])
def test_qgemm_every_epilogue_option_and_ragged_shapes(cuda, m, n, k, opts):
    """Every epilogue option; K with a partial last slice (48, 400) or one
    short slice (16), N no multiple of the 128-wide tile."""
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    _qgemm_check(*chip_smoke.qgemm_inputs(torch, gen, m, n, k, opts)[:5])


# (M, K): a warp a row up to 4096 (DeiT-S's C and MLP, ViT-L's MLP), a CTA a
# row past it: 4104, ViT-H's MLP (5120) at a B=64 forward's rows, ViT-G's
# (8192), 12288 and the ceiling 16384
ROWQ_SHAPES = [(50432, 384), (129, 1536), (65, 4096), (77, 4104), (16448, 5120), (33, 8192),
               (17, 12288), (40, 16384)]


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", ROWQ_SHAPES)
def test_row_quantize_kernel_against_plain(cuda, m, k, dtype, ln):
    """The plain form's codes and scales bit-equal to the plain version's
    (the same rows divided by the same scales); the LayerNorm form's as
    `check_int8_block` holds a LayerNorm-fed quantization (a share of at
    most CODE_FLIP_SHARE codes one step off, scales within SCALE_TOL); rows
    past 4096 counted on the CTA-a-row kernel; two runs bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    h = (torch.randn((m, k), generator=gen, device=cuda) * 3 + 0.25).to(dtype)
    ln_w = 1 + 0.1 * torch.randn((k,), generator=gen, device=cuda) if ln else None
    ln_b = 0.1 * torch.randn((k,), generator=gen, device=cuda) if ln else None
    before, rows_before = quant_ops.row_quantize.launches, quant_ops.ROWQ_ROWS.launches
    q, s = quant_ops.row_quantize(h, ln_w, ln_b)
    q2, s2 = quant_ops.row_quantize(h, ln_w, ln_b)
    torch.cuda.synchronize()
    assert quant_ops.row_quantize.launches == before + 2
    assert quant_ops.ROWQ_ROWS.launches == rows_before + 2 * (k > quant_ops.ROW_WARP_MAX)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    want_q, want_s = quant_ops.row_quantize_reference(h, ln_w, ln_b)
    if not ln:
        assert torch.equal(q, want_q) and torch.equal(s, want_s)
        return
    step = (q.int() - want_q.int()).abs()
    assert step.max().item() <= 1
    assert (step > 0).float().mean().item() <= chip_smoke.CODE_FLIP_SHARE
    assert ((s - want_s).abs() / want_s).max().item() <= chip_smoke.SCALE_TOL


def test_row_quantize_and_the_int8_block_name_the_row_ceiling(cuda):
    assert _cuda.library().d2s_rowq_max_width() == quant_ops.ROW_MAX
    ceiling = f"at most {quant_ops.ROW_MAX}"
    with pytest.raises(ValueError, match=ceiling):
        quant_ops.row_quantize(torch.zeros((4, quant_ops.ROW_MAX + 16), device=cuda))
    x = torch.zeros((1, 13, 1024), device=cuda, dtype=torch.bfloat16)
    qw = {"w1_q": torch.zeros((quant_ops.ROW_MAX + 16, 1024), device=cuda, dtype=torch.int8)}
    with torch.inference_mode(), pytest.raises(ValueError, match=ceiling):
        ops.fused_transformer_block_int8(x, qw, 16, stages=True)


@pytest.mark.parametrize("c,heads,hidden", [(1280, 16, 5120), (5120, 40, 5120)])
def test_int8_block_at_rows_past_4096(cuda, c, heads, hidden):
    """ViT-H/14's block (hidden 5120: the activation's rows) and a
    5120-wide one (C = 5120: both LayerNorm-fed quantizations' rows) held
    stage by stage against the plain version (`check_int8_block`), the rows
    past 4096 on the CTA-a-row kernel: one a block at ViT-H, four at C = 5120."""
    blk = _sharpen(Block(c, heads, mlp_ratio=hidden / c, use_fused=True, quant="int8"),
                   seed=c).to(cuda).eval()
    x = torch.randn((2, 13, c), generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        qw = blk.int8_weights(torch.bfloat16)
        quant_ops.ROWQ_ROWS.launches = 0
        chip_smoke.check_int8_block(torch, x, qw, heads, blk.attn.scale, 1e-6)
        torch.cuda.synchronize()
    assert quant_ops.ROWQ_ROWS.launches == (1 if c <= quant_ops.ROW_WARP_MAX else 4)


def test_qgemm_runs_give_equal_bits(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    a, row_s, w, col_s, kw, _ = chip_smoke.qgemm_inputs(torch, gen, 25216, 1536, 384,
                                                        ("bias", "gelu"))
    first = quant_ops.qgemm(a, row_s, w, col_s, **kw)
    second = quant_ops.qgemm(a, row_s, w, col_s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("c,heads", [(384, 6), (768, 12)])
def test_int8_block_products_are_qgemm_bit_for_bit(cuda, c, heads):
    """The int8 block's four products are the engine's int8 GEMM: each stage
    the block returns equals `qgemm` on the block's own codes and scales."""
    blk = _int8_block(c, c, heads).to(cuda).eval()
    x = torch.randn((4, 197, c), generator=torch.Generator(device=cuda).manual_seed(c),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        qw = blk.int8_weights(torch.bfloat16)
        out, st = ops.fused_transformer_block_int8(x, qw, heads, stages=True)

        def product(i, key, **kw):
            q = st[f"q{i}"]
            return quant_ops.qgemm(q.reshape(-1, q.shape[-1]), st[f"s{i}"].reshape(-1),
                                   qw[f"w{key}_q"], qw[f"s{key}"], qw[f"b{key}"],
                                   **kw).reshape(4, 197, -1)

        rows = (4 * 197, c)
        got = {"qkv": product(1, "qkv"),
               "mid": product(2, "proj", residual=x.reshape(rows), out_dtype=torch.float32),
               "act": product(3, "1", gelu=True),
               "out": product(4, "2", residual=st["mid"].reshape(rows))}
        torch.cuda.synchronize()
    want = {"qkv": st["qkv"], "mid": st["mid"], "act": st["act"], "out": out}
    assert all(torch.equal(got[k], want[k]) for k in want), [
        k for k in want if not torch.equal(got[k], want[k])]


def test_qgemm_refuses_what_the_engine_does_not_take(cuda):
    """K that is no multiple of 16 (376) and N that is no multiple of 8 (12)
    are taken, padded with zero codes (`ops.rowpad`), bit-equal to the plain
    version; the C entry refuses what it does not take."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    a, row_s, w, col_s, kw, _ = chip_smoke.qgemm_inputs(torch, gen, 64, 128, 384, ())
    for args in ((a[:, :376].contiguous(), row_s, w[:, :376].contiguous(), col_s),
                 (a, row_s, w[:12].contiguous(), col_s[:12].contiguous())):
        assert torch.equal(quant_ops.qgemm(*args), quant_ops.qgemm_reference(*args))
    # the C entry itself: both residuals, or no output
    lib = _cuda.library()
    stream = _cuda.stream_handle(cuda)
    res = torch.zeros((64, 128), device=cuda, dtype=torch.bfloat16)
    res32 = torch.zeros((64, 128), device=cuda)
    out = torch.empty((64, 128), device=cuda, dtype=torch.bfloat16)
    ptrs = [a.data_ptr(), row_s.data_ptr(), w.data_ptr(), col_s.data_ptr(), 0]
    assert lib.d2s_qgemm(*ptrs, res.data_ptr(), res32.data_ptr(), out.data_ptr(), 0,
                         64, 128, 384, 0, stream) != 0
    assert lib.d2s_qgemm(*ptrs, 0, 0, 0, 0, 64, 128, 384, 0, stream) != 0
    assert lib.d2s_qgemm(*ptrs, 0, 0, out.data_ptr(), 0, 64, 128, 384, 0, stream) == 0


# ---- the LayerNorm backward and the bias column sums (csrc/norm.cu) --------

# (M, C): the B=128 top-k step's rows at N=197 and N=68, tails that are no
# multiple of 16 rows or of a CTA's run, one row; C for 32 lanes a row (384,
# 768, 128), for 16 (192, 320) and for 32 with a partial last chunk (448 of
# T2T-ViT-19, 576, 704, and the odd multiples of 32: 32, 96, 736); past them
# a row over a CTA (ln_bwd_row_kernel): ViT-L's 1024 and ViT-H's 1280 at a
# B=32 step's rows (197 and 257 tokens), ViT-G's 1664, the ceiling 2048,
# 776 (the first multiple of 8 past 768), 1408 (ViT-g), and the multiples of
# 8 below 768 that are no multiple of 32 (8, 40, 200)
LN_SHAPES = [(25216, 384), (8704, 384), (65, 384), (1, 384), (1003, 768), (63, 192),
             (97, 128), (40, 320), (25216, 448), (77, 448), (130, 576), (33, 704),
             (17, 32), (200, 96), (129, 736), (6304, 1024), (8224, 1280), (65, 1280),
             (1, 1280), (129, 1664), (33, 2048), (77, 776), (40, 1408), (63, 8), (17, 40),
             (130, 200)]


def _ln_inputs(cuda, m, c, res, seed=11):
    gen = torch.Generator(device=cuda).manual_seed(seed + m + c)
    x = (torch.randn((m, c), generator=gen, device=cuda) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn((m, c), generator=gen, device=cuda)
    ln_w = 1 + 0.1 * torch.randn((c,), generator=gen, device=cuda)
    residual = None if res is None else torch.randn((m, c), generator=gen, device=cuda).to(res)
    return dy, x, norm_ops.ln_stats(x, 1e-6), ln_w, residual


@pytest.mark.parametrize("res", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", LN_SHAPES)
def test_ln_backward_kernel_against_plain(cuda, m, c, res):
    """dx's fp32 copy within 1e-5 of its largest magnitude, and its bf16 dx
    that copy rounded to nearest; d_ln_w and d_ln_b within 1e-5 of the sums
    of their terms' magnitudes (fp32 sums in other orders)."""
    dy, x, st, ln_w, residual = _ln_inputs(cuda, m, c, res)
    before, rows_before = norm_ops.LN_BWD.launches, norm_ops.LN_BWD_ROWS.launches
    dx, dx_f, dw, db = norm_ops.ln_backward(dy, x, st, ln_w, residual, fp32_copy=True)
    torch.cuda.synchronize()
    assert norm_ops.LN_BWD.launches == before + 1
    on_rows = c > 768 or c % 32 != 0  # the widths ln_bwd_kernel does not lay out
    assert norm_ops.LN_BWD_ROWS.launches == rows_before + on_rows
    want_dx, want_f, want_dw, want_db = norm_ops.ln_backward_reference(dy, x, st, ln_w,
                                                                       residual, True)
    _assert_close(dx_f, want_f, 1e-5)
    assert torch.equal(dx, dx_f.to(torch.bfloat16)) and want_dx.dtype == dx.dtype
    z = (x.float() - st[:, :1]) * st[:, 1:]
    for got, want, terms in ((dw, want_dw, dy * z), (db, want_db, dy)):
        assert ((got - want).abs() <= 1e-5 * terms.abs().sum(0) + 1e-30).all()


@pytest.mark.parametrize("m,c", [(25216, 384), (8224, 1280)])
def test_ln_backward_gives_equal_bits_on_two_runs(cuda, m, c):
    dy, x, st, ln_w, residual = _ln_inputs(cuda, m, c, torch.float32)
    first = norm_ops.ln_backward(dy, x, st, ln_w, residual, fp32_copy=True)
    second = norm_ops.ln_backward(dy, x, st, ln_w, residual, fp32_copy=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("c", [12, 2056, 4096])
def test_ln_backward_refuses_a_width_it_does_not_take(cuda, c):
    """A width past the ceiling raises naming it, which the library's
    equals; the C entry refuses it too. A width that is no multiple of 8
    (12) is taken: its rows padded, the means over 12 (`ops.rowpad`), within
    LN_TOL of the plain version."""
    dy, x, st, ln_w, _ = _ln_inputs(cuda, 64, c, None)
    assert _cuda.library().d2s_ln_backward_max_width() == norm_ops.LN_BWD_MAX_C
    assert _cuda.library().d2s_ln_backward_workspace_bytes(64, c) == 0
    if c <= norm_ops.LN_BWD_MAX_C:
        got = norm_ops.ln_backward(dy, x, st, ln_w, fp32_copy=True)
        want = norm_ops.ln_backward_reference(dy, x, st, ln_w, fp32_copy=True)
        err, ref = chip_smoke.rel_err(torch, got[1], want[1])
        assert err <= chip_smoke.LN_TOL * ref
        return
    with pytest.raises(ValueError, match=f"at most {norm_ops.LN_BWD_MAX_C} values"):
        norm_ops.ln_backward(dy, x, st, ln_w)


# (M, N, dtype): the top-k step's g (384), dqkv (1152), dy (1536) in bf16 and
# its fp32 da (384) at N=197, and tails
COLSUM_SHAPES = [(25216, 384, torch.bfloat16), (25216, 1152, torch.bfloat16),
                 (25216, 1536, torch.bfloat16), (25216, 384, torch.float32),
                 (8704, 1536, torch.bfloat16), (63, 384, torch.bfloat16),
                 (65, 1152, torch.float32), (1, 8, torch.float32)]


def _colsum_input(cuda, m, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    return torch.randn((m, n), generator=gen, device=cuda).to(dtype)


@pytest.mark.parametrize("m,n,dtype", COLSUM_SHAPES)
def test_column_sums_kernel_against_plain(cuda, m, n, dtype):
    """Within 1e-5 of the sum of each column's magnitudes (fp32 sums in other
    orders); two runs bit-equal."""
    a = _colsum_input(cuda, m, n, dtype)
    before = norm_ops.COLUMN_SUMS.launches
    got, again = norm_ops.column_sums(a), norm_ops.column_sums(a)
    torch.cuda.synchronize()
    assert norm_ops.COLUMN_SUMS.launches == before + 2
    want = norm_ops.column_sums_reference(a)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert ((got - want).abs() <= 1e-5 * a.float().abs().sum(0) + 1e-30).all()
    assert torch.equal(got, again)


def test_column_sums_refuse_what_the_kernel_does_not_take(cuda):
    """N = 12 is taken (zero columns past it); a float16 matrix is refused."""
    a = _colsum_input(cuda, 16, 12, torch.float32)
    got = norm_ops.column_sums(a)
    assert got.shape == (12,)
    assert ((got - a.sum(0)).abs() <= 1e-5 * a.abs().sum(0) + 1e-30).all()
    with pytest.raises(ValueError, match="bf16 or fp32"):
        norm_ops.column_sums(torch.zeros((16, 16), device=cuda, dtype=torch.float16))


@pytest.mark.parametrize("m,i,j", [(25216, 384, 1536), (25216, 1536, 384), (25216, 1152, 384),
                                   (25216, 384, 384), (8704, 1536, 384), (63, 384, 384),
                                   (65, 1152, 384), (1, 384, 1536)])
def test_weight_grad_folds_the_bias_sums_and_keeps_dw_bits(cuda, m, i, j):
    """The bias gradient summed on the weight gradient's reads of P: within
    1e-5 of the sum of each column's magnitudes, bit-equal on two runs; dW
    bit-equal to the product without the sums."""
    gen = torch.Generator(device=cuda).manual_seed(m + i + j)
    p = torch.randn((m, i), generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn((m, j), generator=gen, device=cuda).to(torch.bfloat16)
    dw, db = gemm_ops.weight_grad(p, q, bias=True)
    dw2, db2 = gemm_ops.weight_grad(p, q, bias=True)
    plain = gemm_ops.weight_grad(p, q)
    torch.cuda.synchronize()
    assert torch.equal(dw, plain) and torch.equal(dw, dw2) and torch.equal(db, db2)
    assert ((db - p.float().sum(0)).abs() <= 1e-5 * p.float().abs().sum(0) + 1e-30).all()


@pytest.mark.parametrize("n", [197, 13])
def test_block_backward_and_mlp_half_at_448_wide(cuda, n):
    """T2T-ViT-19's width (C = 448, 7 heads, MLP ratio 3): the block
    backward and the MLP half's backward against their plain versions,
    through the LayerNorm backward's partial last chunk."""
    blk = _sharpen(Block(448, 7, mlp_ratio=3.0, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 448), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, n, 448), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        dx, dw, _ = ops.fused_transformer_block_backward(x, g, w, 7)
        want_dx, want_dw, _ = transformer_block_backward_reference(
            x, g, w, 7, blk.attn.scale, 1e-6)
        mw = [w[k] for k in ("ln2_w", "ln2_b", "w1", "b1", "w2")]
        grads = ops.fused_mlp_residual_backward(x, g, *mw)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block_backward": 1,
                                   "fused_mlp_residual_backward": 1,
                                   **_norm(blocks=1, halves=1), **_core(1)}
    _assert_close(dx, want_dx, BWD_TOL)
    for k in BLOCK_WEIGHT_KEYS:
        _assert_close(dw[k], want_dw[k], BWD_TOL)
    for a, b in zip(grads, mlp_residual_backward_reference(x, g, *mw, 1e-6)):
        _assert_close(a, b, BWD_TOL)


# (C, heads, N): ViT-L/16 (1024, 16 heads of 64) at 197 tokens, ViT-H/14
# (1280, 16 of 80) at its four stages' 257 and 88 tokens, ViT-G/14 (1664,
# 16 of 104) at 13
WIDE_BLOCKS = [(1024, 16, 197), (1280, 16, 257), (1280, 16, 88), (1664, 16, 13)]


@pytest.mark.parametrize("c,heads,n", WIDE_BLOCKS)
def test_block_backward_and_mlp_half_past_768_wide(cuda, c, heads, n):
    """Widths past 768 (MLP ratio 4): the block backward, the MLP half
    both ways and the attention half-block's backward against their plain
    versions, their LayerNorm backwards on the CTA-a-row kernel (one a
    half's backward, two a block's); two block backwards bit-equal."""
    blk = _sharpen(Block(c, heads, use_fused=True), seed=n).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((2, n, c), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((2, n, c), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        norm_ops.LN_BWD_ROWS.launches = 0
        dx, dw, _ = ops.fused_transformer_block_backward(x, g, w, heads)
        mw = [w[k] for k in ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")]
        y = ops.fused_mlp_residual(x, *mw, 1e-6)
        grads = ops.fused_mlp_residual_backward(x, g, *mw[:5])
        hw = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj")]
        hdx, *hdw = ops.fused_attention_block_backward(x, g, *hw, heads)
        dx2, dw2, _ = ops.fused_transformer_block_backward(x, g, w, heads)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert norm_ops.LN_BWD_ROWS.launches == counts["ln_bwd"] == 2 + 1 + 1 + 2
        assert counts["fused_transformer_block_backward"] == 2
        assert counts["fused_mlp_residual"] == counts["fused_mlp_residual_backward"] == 1
        assert counts["attention_block_backward"] == 1
        assert torch.equal(dx, dx2) and all(torch.equal(dw[k], dw2[k]) for k in dw
                                            if dw[k] is not None)
        want_dx, want_dw, _ = transformer_block_backward_reference(
            x, g, w, heads, blk.attn.scale, 1e-6)
        _assert_close(dx, want_dx, BWD_TOL)
        for k in BLOCK_WEIGHT_KEYS:
            _assert_close(dw[k], want_dw[k], BWD_TOL)
        _assert_close(y, mlp_residual_reference(x, *mw, 1e-6))
        for a, b in zip(grads, mlp_residual_backward_reference(x, g, *mw[:5], 1e-6)):
            _assert_close(a, b, BWD_TOL)
        want_hdx, want_hdw, _ = attention_block_backward_reference(
            x, g, *hw, heads, scale=blk.attn.scale)
        _assert_close(hdx, want_hdx, BWD_TOL)
        for k, got in zip(ATTN_BLOCK_KEYS, hdw):
            _assert_close(got, want_hdw[k], BWD_TOL)


def test_backward_wrappers_name_the_layernorm_ceiling(cuda):
    """Past LN_BWD_MAX_C every backward entry raises naming it, before
    anything touches the device; the forwards take the width."""
    c, heads = norm_ops.LN_BWD_MAX_C + 32, 20
    x = torch.zeros((1, 13, c), device=cuda, dtype=torch.bfloat16)
    w = {"w1": torch.zeros((4 * c, c), device=cuda, dtype=torch.bfloat16)}
    ceiling = f"at most {norm_ops.LN_BWD_MAX_C} values"
    with torch.no_grad():
        with pytest.raises(ValueError, match=ceiling):
            ops.fused_transformer_block_backward(x, x, w, heads)
        with pytest.raises(ValueError, match=ceiling):
            ops.fused_mlp_residual_backward(x, x, None, None, w["w1"], None, None)
        with pytest.raises(ValueError, match=ceiling):
            ops.fused_attention_block_backward(x, x, None, None, None, None, None, heads)


def test_block_backward_bias_and_layernorm_gradients_are_bit_equal_on_two_runs(cuda):
    """Every gradient of the block backward, dgamma, dbeta and the biases
    among them, the same bits on two runs (fixed-order sums, no atomics);
    each call launches the LayerNorm backward twice and the column sums once."""
    blk = _sharpen(Block(384, 6, use_fused=True), seed=9).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((128, 197, 384), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        w = blk.kernel_weights(torch.bfloat16)
        ops.reset_launch_counts()
        dx, dw, _ = ops.fused_transformer_block_backward(x, g, w, 6)
        dx2, dw2, _ = ops.fused_transformer_block_backward(x, g, w, 6)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {**NO_LAUNCHES, "fused_transformer_block_backward": 2,
                                   **_norm(blocks=2), **_core(2)}
    assert torch.equal(dx, dx2)
    assert set(dw) == set(dw2) and all(dw[k] is not None and torch.equal(dw[k], dw2[k])
                                       for k in dw)


# ---- the attention core's backward (attention_bwd_kernel) -----------------
# through `fused_attention_backward_packed`, which launches the forward core
# (its output and row statistics), then the kernel, then dPolicy's head sum

CORE_SCALE = 64 ** -0.5


def _core_case(cuda, n, policy=False, with_gcls=False, strided=False, b=2, seed=0):
    """qkv (b, n, 3 * 384) at 6 heads (a strided view: rows 4C apart, the
    samples one row further apart, with `strided`), the output's cotangent,
    and where asked a keep policy and the CLS rows' cotangent."""
    gen = torch.Generator(device=cuda).manual_seed(1000 * seed + n)
    bf16 = torch.bfloat16
    if strided:
        qkv = torch.randn((b, n + 1, 4 * 384), generator=gen, device=cuda).to(bf16)[:, 1:, :1152]
    else:
        qkv = torch.randn((b, n, 1152), generator=gen, device=cuda).to(bf16)
    g = torch.randn((b, n, 384), generator=gen, device=cuda).to(bf16)
    gcls = torch.randn((b, 6, n), generator=gen, device=cuda) if with_gcls else None
    return qkv, g, (_policy(gen, b, n, cuda) if policy else None), gcls


def _core_both(qkv, g, pol, gcls, eps=1e-6):
    """The packed backward (the kernel on the recomputed forward), its
    launches, and the plain version; each as (dqkv, dPolicy or None)."""
    kw = {} if pol is None else {"policy": pol, "eps": eps}
    with torch.no_grad():
        ops.reset_launch_counts()
        got = ops.fused_attention_backward_packed(qkv, g, 6, gcls=gcls, scale=CORE_SCALE, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = attention_backward_reference(qkv, g, 6, CORE_SCALE, gcls=gcls, **kw)
    want_counts = chip_smoke.core_launches(1, n=qkv.shape[1])
    assert counts == {**NO_LAUNCHES, "fused_attention_backward_packed": 1, **want_counts}
    return (got if pol is not None else (got, None)), want


def _core_close(dqkv, want, dpol=None, want_dpol=None):
    """dqkv's q, k and v apart within BWD_TOL, dPolicy within the check's
    DPOL_TOL. At N=1 the one probability is 1 and dS = 0: dQ, dK and
    dPolicy vanish in exact arithmetic and both sides hold fp32 rounding of
    dP - D, so they are held to 1e-3 of dV's scale instead."""
    if dqkv.shape[1] > 1:
        _thirds_close(dqkv, want)
        if dpol is not None:
            _assert_close(dpol, want_dpol, chip_smoke.DPOL_TOL)
        return
    c2 = 2 * dqkv.shape[-1] // 3  # where v's third starts
    dv = want[..., c2:].float().abs().max().item()
    _assert_close(dqkv[..., c2:], want[..., c2:], BWD_TOL)
    assert dqkv[..., :c2].float().abs().max().item() <= 1e-3 * dv
    assert dpol is None or dpol.abs().max().item() <= 1e-3 * dv


@pytest.mark.parametrize("n", [1, 15, 16, 17, 63, 64, 65, 129, 197, 384, 385, 404, 577, 768,
                               769, 785, 800, 801, 1025, 3601])
@pytest.mark.parametrize("with_gcls", [False, True])
def test_attention_bwd_kernel_against_plain(cuda, n, with_gcls):
    """Plain mode at every edge of the 16-row and 64-row tiles up to the
    kernel's largest N, the long path (N > 384: 2 and 3 CTAs a sample-head)
    included: dqkv's q, k and v apart within BWD_TOL, with and without the
    CLS rows' cotangent; past 800 tokens the attention_hd pair at width 64."""
    qkv, g, _, gcls = _core_case(cuda, n, with_gcls=with_gcls)
    (dqkv, _), (want, _) = _core_both(qkv, g, None, gcls)
    _core_close(dqkv, want)


@pytest.mark.parametrize("n", [1, 17, 65, 129, 197, 352, 353, 404, 577, 785, 800, 801, 1025,
                               3601])
@pytest.mark.parametrize("eps", [1e-6, 0.1])
@pytest.mark.parametrize("with_gcls", [False, True])
def test_attention_bwd_kernel_policy_against_plain(cuda, n, eps, with_gcls):
    """Policy mode up to its largest N, the long path (N > 352) included:
    dqkv within BWD_TOL and dPolicy within the check's DPOL_TOL, at the
    model's eps and at a visible one."""
    qkv, g, pol, gcls = _core_case(cuda, n, policy=True, with_gcls=with_gcls, seed=1)
    (dqkv, dpol), (want, want_dpol) = _core_both(qkv, g, pol, gcls, eps)
    _core_close(dqkv, want, dpol, want_dpol)


@pytest.mark.parametrize("n", [65, 197])
@pytest.mark.parametrize("policy", [False, True])
def test_attention_bwd_kernel_on_a_strided_view(cuda, n, policy):
    """qkv read in place from wider rows, the samples not packed (its TMA
    maps' strides), with the CLS fold."""
    qkv, g, pol, gcls = _core_case(cuda, n, policy=policy, with_gcls=True, strided=True, seed=2)
    assert not qkv.is_contiguous()
    (dqkv, dpol), (want, want_dpol) = _core_both(qkv, g, pol, gcls, 0.1)
    _thirds_close(dqkv, want)
    if policy:
        _assert_close(dpol, want_dpol, chip_smoke.DPOL_TOL)


@pytest.mark.parametrize("eps", [1e-6, 0.1])
def test_attention_bwd_kernel_dpolicy_on_planted_ties(cuda, eps):
    """The same key in six columns, and the first 98 queries shifted towards
    it, so that those rows reach their max at the six columns with equal
    scores (six ties, counted here in float64), and the max path's share
    reaches every tied column (dPolicy and dqkv within tolerance of autograd
    through torch.amax, which splits it evenly). Half the rows stay
    unshifted: a row that puts all its mass on six equal keys has dQ = 0 in
    exact arithmetic, which bf16 dS leaves as rounding."""
    qkv, g, pol, _ = _core_case(cuda, 197, policy=True, seed=3)
    cols = [5, 17, 40, 41, 100, 150]
    qkv[:, :98, :384] += 2.0
    qkv[:, cols, 384:768] = 2.0
    q, k = (qkv[..., i * 384:(i + 1) * 384].double().view(2, 197, 6, 64).transpose(1, 2)
            for i in (0, 1))
    s = q @ k.transpose(-1, -2)  # float64: the six copies' scores are equal
    ties = (s == s.amax(-1, keepdim=True)).sum(-1)
    assert (ties == len(cols)).double().mean().item() > 0.4
    (dqkv, dpol), (want, want_dpol) = _core_both(qkv, g, pol, None, eps)
    _thirds_close(dqkv, want)
    _assert_close(dpol, want_dpol, chip_smoke.DPOL_TOL)


@pytest.mark.parametrize("n", [197, 577, 1025, 3601])
@pytest.mark.parametrize("policy", [False, True])
def test_attention_bwd_kernel_is_bit_equal_on_two_launches(cuda, policy, n):
    """dqkv (and dPolicy) the same bits on two launches at B=128, N=197, on
    the long path at N=577 and on the attention_hd pair at N=1025 and 3601
    (its passes split over 3 and 8 CTAs a sample-head): every sum in a fixed
    order, no atomics."""
    qkv, g, pol, gcls = _core_case(cuda, n, policy=policy, with_gcls=True, b=128, seed=4)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        runs = [ops.fused_attention_backward_packed(qkv, g, 6, gcls=gcls, scale=CORE_SCALE, **kw)
                for _ in range(2)]
    a, b = runs if policy else ((runs[0], None), (runs[1], None))
    assert torch.equal(a[0], b[0])
    assert not policy or torch.equal(a[1], b[1])


# (d, heads, N): the width-64 core at DeiT-S's width and ViT-H/14's 80 on
# the attention_hd pair, at its stages' token counts, past 800 tokens, and
# an odd width and one past 128
D_CASES = [(64, 6, 197), (64, 6, 68), (80, 16, 257), (80, 16, 88), (64, 12, 1025),
           (127, 8, 197), (256, 3, 197)]


@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("d,heads,n", D_CASES)
def test_attention_bwd_holds_d_where_the_values_share_a_large_part(cuda, d, heads, n, policy):
    """D = rowsum(dO * O) where every value row is one large vector plus a
    small spread (deep in a ViT-H/14 the value rows came to share most of
    their size): the core backward's dQ and dK within 1e-2 of the fp32
    truth's largest magnitude (autograd through the plain version in fp32),
    as the plain bf16 version is (~0.5%); O's bf16 rounding alone in D moved
    them by ~3%."""
    gen = torch.Generator(device=cuda).manual_seed(d + n)
    c = d * heads
    qkv = torch.randn((2, n, 3 * c), generator=gen, device=cuda)
    common = 4 * torch.randn((1, 1, c), generator=gen, device=cuda)
    qkv[..., 2 * c:] = common + 0.25 * qkv[..., 2 * c:]
    qkv = qkv.to(torch.bfloat16)
    g = torch.randn((2, n, c), generator=gen, device=cuda).to(torch.bfloat16)
    kw = {"policy": _policy(gen, 2, n, cuda), "eps": 0.1} if policy else {}
    scale = d ** -0.5
    with torch.no_grad():
        got = ops.fused_attention_backward_packed(qkv, g, heads, scale=scale, **kw)
        want, _ = attention_backward_reference(qkv.float(), g.float(), heads, scale, **kw)
        torch.cuda.synchronize()
    got = got[0] if policy else got
    for a, b in zip(got.chunk(3, -1)[:2], want.chunk(3, -1)[:2]):
        _assert_close(a, b, 1e-2)


def test_attention_bwd_kernel_refuses_what_it_does_not_take(cuda):
    """N past the ceiling (`ops.block.attention_max_tokens`, shared memory)
    is refused by the wrapper, naming the limit, and by the C entry itself
    (cudaErrorInvalidValue), whose ceiling is the same."""
    lib = _cuda.library()
    for policy in (False, True):
        limit = block_ops.attention_max_tokens(64, policy=policy, backward=True)
        assert lib.d2s_attention_max_tokens(64, int(policy), 1) == limit >= 3601
        n = limit + 1
        qkv, g, pol, _ = _core_case(cuda, n, policy=policy)
        with pytest.raises(ValueError, match=f"the kernels take 1 to {limit}"):
            ops.fused_attention_backward_packed(qkv, g, 6, policy=pol)
        f32 = torch.float32
        o = torch.empty((2, *g.shape), dtype=g.dtype, device=cuda)  # O, then its residual
        stats = torch.empty((2, 6, n, 4), dtype=f32, device=cuda)
        part = torch.empty((2, 6, n), dtype=f32, device=cuda)
        dpol = torch.empty((2, n), dtype=f32, device=cuda)
        dqkv = torch.empty_like(qkv)
        err = _cuda.library().d2s_attention_packed_backward(
            qkv.data_ptr(), qkv.stride(0), qkv.stride(1), g.data_ptr(), 0,
            0 if pol is None else pol.data_ptr(), dqkv.data_ptr(),
            0 if pol is None else dpol.data_ptr(), o.data_ptr(), stats.data_ptr(),
            0 if pol is None else part.data_ptr(), 0, 2, n, 6, 384, CORE_SCALE, 1e-6,
            _cuda.stream_handle(cuda))
        assert err == 1


# ---- the attention cores at head widths other than 64 ----------------------

# (head width, heads): the zoo's t2t_vit_14_resnext (C = 384) and
# vit_small_patch16_224 (C = 768); 32 and 128 the padded path's edges, 2 its
# 4-byte copies; 16, 48, 80 and 112 the other padded widths
HD_CASES = ((12, 32), (96, 8))
HD_EDGES = ((32, 12), (128, 6), (2, 192))
HD_MORE = ((16, 8), (48, 8), (80, 8), (112, 4))
# N: one key block and its edges, the backward's one pass (N <= 128) and
# its first with a second (129), the zoo's sequences, the width-64 core's
# longest and past it
HD_TOKENS = [1, 17, 63, 64, 65, 128, 129, 197, 577, 785, 800, 801, 1025]


def _hd_case(cuda, d, H, n, b=2, policy=False, with_gcls=False, seed=0):
    """qkv (b, n, 3 H d), the output's cotangent, a keep policy and the CLS
    rows' cotangent where asked, at head width d."""
    gen = torch.Generator(device=cuda).manual_seed(1000 * seed + 10 * n + d)
    C = d * H
    qkv = torch.randn((b, n, 3 * C), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((b, n, C), generator=gen, device=cuda).to(torch.bfloat16)
    gcls = torch.randn((b, H, n), generator=gen, device=cuda) if with_gcls else None
    return qkv, g, (_policy(gen, b, n, cuda) if policy else None), gcls


@pytest.mark.parametrize("d,H", HD_CASES + HD_EDGES + HD_MORE)
@pytest.mark.parametrize("n", HD_TOKENS)
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_packed_forward_against_plain(cuda, d, H, n, policy):
    """The forward core at head width d (attention_hd_kernel): output and CLS
    rows against the plain version, at eps 0.1 in policy mode; one launch of
    the packed entry and one of the core."""
    qkv, _, pol, _ = _hd_case(cuda, d, H, n, policy=policy)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        ops.reset_launch_counts()
        out, cls = ops.fused_attention_packed(qkv, H, return_cls=True, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want, want_cls = attention_reference(qkv, H, d ** -0.5, return_cls=True, **kw)
    assert counts == {**NO_LAUNCHES, "fused_attention_packed": 1, "attention_hd": 1}
    _assert_close(out, want)
    _assert_close(cls, want_cls)


@pytest.mark.parametrize("d,H", HD_CASES + HD_EDGES + HD_MORE)
@pytest.mark.parametrize("n", HD_TOKENS)
@pytest.mark.parametrize("policy", [False, True])
@pytest.mark.parametrize("with_gcls", [False, True])
def test_head_width_packed_backward_against_plain(cuda, d, H, n, policy, with_gcls):
    """The backward core at head width d (attention_hd_bwd_kernel): dqkv's q,
    k and v apart and dPolicy against the plain version; the forward
    recompute and the backward launched once each."""
    qkv, g, pol, gcls = _hd_case(cuda, d, H, n, policy=policy, with_gcls=with_gcls, seed=1)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        ops.reset_launch_counts()
        got = ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = attention_backward_reference(qkv, g, H, d ** -0.5, gcls=gcls, **kw)
    assert counts == {**NO_LAUNCHES, "fused_attention_backward_packed": 1, "attention_hd": 1,
                      "attention_hd_bwd": 1}
    (dqkv, dpol), (want_dqkv, want_dpol) = (got if pol is not None else (got, None)), want
    _core_close(dqkv, want_dqkv, dpol, want_dpol)


@pytest.mark.parametrize("d,H", HD_CASES)
@pytest.mark.parametrize("n", [65, 197, 577])
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_forward_is_bit_equal_on_two_launches(cuda, d, H, n, policy):
    qkv, _, pol, _ = _hd_case(cuda, d, H, n, b=64, policy=policy, seed=4)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        runs = [ops.fused_attention_packed(qkv, H, return_cls=True, **kw) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("d,H", HD_CASES)
@pytest.mark.parametrize("n", [65, 197, 577])
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_backward_is_bit_equal_on_two_launches(cuda, d, H, n, policy):
    qkv, g, pol, gcls = _hd_case(cuda, d, H, n, b=64, policy=policy, with_gcls=True, seed=2)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        runs = [ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, **kw) for _ in range(2)]
    a, b = runs if policy else ((runs[0], None), (runs[1], None))
    assert torch.equal(a[0], b[0])
    assert not policy or torch.equal(a[1], b[1])


@pytest.mark.parametrize("d,H", HD_CASES)
@pytest.mark.parametrize("eps", [1e-6, 0.1])
def test_head_width_dpolicy_on_planted_ties(cuda, d, H, eps):
    """Six keys equal, the first half of the queries shifted towards them:
    those rows reach their max at six columns (counted in float64), and the
    max path's share reaches each (against autograd through torch.amax)."""
    qkv, g, pol, _ = _hd_case(cuda, d, H, 197, policy=True, seed=3)
    C = d * H
    cols = [5, 17, 40, 41, 100, 150]
    qkv[:, :98, :C] += 2.0
    qkv[:, cols, C:2 * C] = 2.0
    q, k = (qkv[..., i * C:(i + 1) * C].double().view(2, 197, H, d).transpose(1, 2)
            for i in (0, 1))
    s = q @ k.transpose(-1, -2)
    ties = (s == s.amax(-1, keepdim=True)).sum(-1)
    assert (ties == len(cols)).double().mean().item() > 0.4
    with torch.no_grad():
        dqkv, dpol = ops.fused_attention_backward_packed(qkv, g, H, policy=pol, eps=eps)
        want, want_dpol = attention_backward_reference(qkv, g, H, d ** -0.5, policy=pol, eps=eps)
    _thirds_close(dqkv, want)
    _assert_close(dpol, want_dpol, chip_smoke.DPOL_TOL)


@pytest.mark.parametrize("d,H", HD_CASES)
@pytest.mark.parametrize("n", [68, 197, 577])
@pytest.mark.parametrize("mode", ["plain", "policy", "scaled"])
def test_head_width_block_both_ways(cuda, d, H, n, mode):
    """The whole block at head width d, forward stage by stage (with its CLS
    rows in plain and policy mode) and backward with dPolicy, through
    chip_smoke's checks; the launches of the block and the cores."""
    C = d * H
    blk = _sharpen(Block(C, H, mlp_ratio=3.0, use_fused=True), seed=n + d).to(cuda).eval()
    w = blk.kernel_weights(torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, C), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, n, C), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, 4, n, cuda) if mode == "policy" else None
    scales = (chip_smoke.droppath_scales(torch, 4, gen) if mode == "scaled" else None)
    args = (H, d ** -0.5, 1e-6)
    with torch.no_grad():
        ops.reset_launch_counts()
        chip_smoke.check_block(torch, x, w, *args, policy=pol, eps=0.1, branch_scales=scales)
        chip_smoke.check_block_backward(torch, x, g, w, *args, policy=pol, eps=0.1,
                                        branch_scales=scales)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if mode != "scaled":
            out, cls = ops.fused_transformer_block_cls(x, w, H, pol, eps=0.1)
            want, want_cls = transformer_block_reference(x, w, *args, policy=pol, eps=0.1,
                                                         return_cls=True)
            _assert_close(out, want)
            _assert_close(cls, want_cls)
    fwd = chip_smoke.block_kernel_name("fused_transformer_block", pol is not None, scales)
    bwd = chip_smoke.block_kernel_name("fused_transformer_block_backward", pol is not None,
                                       scales)
    assert counts == {**NO_LAUNCHES, fwd: 1, bwd: 1, **_norm(1), "attention_hd": 2,
                      "attention_hd_bwd": 1}


@pytest.mark.parametrize("d,H", HD_CASES)
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_half_block_both_ways(cuda, d, H, policy):
    C = d * H
    blk = _sharpen(Block(C, H, use_fused=True), seed=d).to(cuda).eval()
    w = blk.kernel_weights(torch.bfloat16)
    w6 = tuple(w[k] for k in chip_smoke.HALF_BLOCK_KEYS)
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn((4, 197, C), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((4, 197, C), generator=gen, device=cuda).to(torch.bfloat16)
    pol = _policy(gen, 4, 197, cuda) if policy else None
    with torch.no_grad():
        chip_smoke.check_attn_half(torch, x, w6, H, d ** -0.5, 1e-6, policy=pol, eps=0.1,
                                   cls=True)
        chip_smoke.check_attn_half_backward(torch, x, g, w6, H, d ** -0.5, 1e-6, policy=pol,
                                            eps=0.1)


@pytest.mark.parametrize("n", [197, 577])
def test_head_width_int8_block(cuda, n):
    blk = _sharpen(Block(768, 8, mlp_ratio=3.0, use_fused=True), seed=n).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, 768), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        chip_smoke.check_int8_block(torch, x, blk.int8_weights(torch.bfloat16), 8, 96 ** -0.5,
                                    1e-6)


def test_head_widths_the_kernels_refuse(cuda):
    """Head widths past 256 are refused by every wrapper with the width in
    the message, and by the C entries themselves."""
    for C, H, width in ((514, 2, "257"), (768, 2, "384")):
        qkv = torch.zeros((2, 17, 3 * C), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"head width {width}"):
            ops.fused_attention_packed(qkv, H)
        with pytest.raises(ValueError, match=f"head width {width}"):
            ops.fused_attention_backward_packed(qkv, qkv[..., :C].contiguous(), H)
    lib = _cuda.library()
    assert lib.d2s_attention_bwd_part_floats(1, 2, 17, 2, 514, 1) == -1
    assert lib.d2s_attention_bwd_part_floats(1, 2, 17, 2, 24, 1) == 2 * 2 * 17
    assert lib.d2s_attention_bwd_part_floats(1, 2, 17, 2, 26, 1) == 2 * 2 * 17  # d = 13
    # dQ's fp32 sum over the head-width backward's passes: (B*N, C) past 128
    # tokens (two key blocks a pass), past 64 from d = 129 on (one)
    assert lib.d2s_attention_bwd_part_floats(0, 2, 577, 2, 24, 0) == 2 * 577 * 24
    assert lib.d2s_attention_bwd_part_floats(0, 2, 128, 2, 24, 0) == 0
    assert lib.d2s_attention_bwd_part_floats(0, 2, 65, 2, 320, 0) == 2 * 65 * 320
    assert lib.d2s_attention_bwd_part_floats(0, 2, 64, 2, 320, 0) == 0
    assert lib.d2s_block_backward_scratch_bytes(2, 17, 528, 2, 1056, 0) == 0
    assert lib.d2s_block_backward_scratch_bytes(2, 17, 26, 2, 104, 0) == 0  # C % 8


# ---- odd head widths and widths past 128 ------------------------------------

# (head width, heads): odd widths at 8 heads (C % 8 == 0: the packed
# entries' row strides, the block's row rule) across the padded widths 16,
# 64, 80, 128 and 144; past 128 each of the
# backward's part layouts (hd_bwd_parts: 2 x 80 at DP = 144 and 160, 2 x 96
# at 192, 4 x 64 at 256) and d = 255 / 256, the ceiling
HD_NEW = ((3, 8), (13, 8), (63, 8), (65, 8), (127, 8), (129, 8), (130, 4), (160, 2),
          (192, 2), (255, 8), (256, 3))
HD_NEW_TOKENS = [1, 13, 64, 65, 128, 129, 197, 577, "ceiling"]


def _tokens(d, n, policy):
    """n, or the width's ceiling both ways in the mode (capped at 4096 for
    the plain version's memory)."""
    if n != "ceiling":
        return n
    return min(block_ops.attention_max_tokens(d, policy=policy, backward=True), 4096)


@pytest.mark.parametrize("d,H", HD_NEW)
@pytest.mark.parametrize("n", HD_NEW_TOKENS)
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_new_widths_packed_both_ways(cuda, d, H, n, policy):
    """The packed attention at an odd width or one past 128, forward (output
    and CLS rows) and backward with the CLS fold (dqkv's thirds and
    dPolicy), against the plain versions; the launches counted at the
    width's padded width and parity (`d2s_attention_hd_dp_launches`)."""
    n = _tokens(d, n, policy)
    b = 1 if n > 1024 else 2
    qkv, g, pol, gcls = _hd_case(cuda, d, H, n, b=b, policy=policy, with_gcls=True, seed=5)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    lib, dp = _cuda.library(), (d + 15) // 16 * 16
    for which in (0, 1):
        lib.d2s_attention_hd_dp_launches(which, dp, d % 2, 0)
    with torch.no_grad():
        out, cls = ops.fused_attention_packed(qkv, H, return_cls=True, **kw)
        got = ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, **kw)
        torch.cuda.synchronize()
        want, want_cls = attention_reference(qkv, H, d ** -0.5, return_cls=True, **kw)
        want_b = attention_backward_reference(qkv, g, H, d ** -0.5, gcls=gcls, **kw)
    assert [lib.d2s_attention_hd_dp_launches(w, dp, d % 2, -1) for w in (0, 1)] == [2, 1]
    _assert_close(out, want)
    _assert_close(cls, want_cls)
    (dqkv, dpol), (want_dqkv, want_dpol) = (got if pol is not None else (got, None)), want_b
    _core_close(dqkv, want_dqkv, dpol, want_dpol)


@pytest.mark.parametrize("d,H", [(13, 8), (256, 3)])
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_new_widths_are_bit_equal_on_two_launches(cuda, d, H, policy):
    qkv, g, pol, gcls = _hd_case(cuda, d, H, 577, b=8, policy=policy, with_gcls=True, seed=6)
    kw = {} if pol is None else {"policy": pol, "eps": 0.1}
    with torch.no_grad():
        fwd = [ops.fused_attention_packed(qkv, H, return_cls=True, **kw) for _ in range(2)]
        bwd = [ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, **kw) for _ in range(2)]
    assert torch.equal(fwd[0][0], fwd[1][0]) and torch.equal(fwd[0][1], fwd[1][1])
    a, b = bwd if policy else ((bwd[0], None), (bwd[1], None))
    assert torch.equal(a[0], b[0])
    assert not policy or torch.equal(a[1], b[1])


@pytest.mark.parametrize("d,H", [(13, 8), (127, 8), (160, 2), (256, 3)])
@pytest.mark.parametrize("eps", [1e-6, 0.1])
def test_head_width_new_widths_dpolicy_on_planted_ties(cuda, d, H, eps):
    test_head_width_dpolicy_on_planted_ties(cuda, d, H, eps)


@pytest.mark.parametrize("d,H", [(13, 8), (127, 8), (160, 2), (256, 3)])
@pytest.mark.parametrize("n", [13, 197, 577])
@pytest.mark.parametrize("mode", ["plain", "policy", "scaled"])
def test_head_width_new_widths_block_both_ways(cuda, d, H, n, mode):
    test_head_width_block_both_ways(cuda, d, H, n, mode)


@pytest.mark.parametrize("d,H", [(13, 8), (256, 3)])
@pytest.mark.parametrize("policy", [False, True])
def test_head_width_new_widths_half_block_both_ways(cuda, d, H, policy):
    test_head_width_half_block_both_ways(cuda, d, H, policy)


@pytest.mark.parametrize("d,H", [(127, 16), (256, 3)])  # C % 16 == 0: the int8 rows' rule
@pytest.mark.parametrize("n", [13, 197, 577])
def test_head_width_new_widths_int8_block(cuda, d, H, n):
    C = d * H
    blk = _sharpen(Block(C, H, mlp_ratio=3.0, use_fused=True), seed=n + d).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((4, n, C), generator=gen, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        chip_smoke.check_int8_block(torch, x, blk.int8_weights(torch.bfloat16), H, d ** -0.5,
                                    1e-6)


def test_the_library_ceiling_is_the_wrappers_at_every_width(cuda):
    """`d2s_attention_max_tokens` equals `ops.block.attention_max_tokens` at
    every d from 1 to 257 in both modes and directions, is at least 577 both
    ways at every d up to 256 (a DeiT-B/16 of such heads at 384 px) and 0
    past it."""
    lib = _cuda.library()
    for d in range(1, 258):
        for policy in (0, 1):
            for backward in (0, 1):
                want = block_ops.attention_max_tokens(d, policy=bool(policy),
                                                      backward=bool(backward))
                assert lib.d2s_attention_max_tokens(d, policy, backward) == want, (d, policy)
                assert want >= 577 if d <= 256 else want == 0


# ---- token rows of every width (ops/rowpad.py, the narrow gather, scatter and predictor)


@pytest.mark.parametrize("C,H", [(39, 3), (104, 8), (381, 3), (380, 4), (1016, 8)])
def test_row_widths_kernels_against_plain(cuda, C, H):
    """At widths off the 16-byte rules (odd C, C % 8 = 4, C % 16 = 8) every
    padded or narrow route against its plain version: the gather and
    scatter bit-equal, the block stage by stage in plain and policy mode
    with its CLS rows and its backward (`chip_smoke.check_block`,
    `check_block_backward`, `check_cls_stage`), the LayerNorm backward
    (`check_ln_bwd`), the int8 block (`check_int8_block`), the small
    predictor (`check_predictor`); each route's launches counted in
    `ops.rowpad.PADDED` where its widths need it."""
    from dense2sparse_vit_torch.ops import rowpad

    w = chip_smoke.hd_block(torch, cuda, C, H, seed=C)
    scale = (C // H) ** -0.5
    gen = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn((2, 24, C), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((2, 24, C), generator=gen, device=cuda).to(torch.bfloat16)
    pol = (torch.rand((2, 24), generator=gen, device=cuda) < 0.6).float()
    pol[:, 0] = 1.0
    idx = torch.randint(-1, 25, (2, 17), generator=gen, device=cuda)
    rowpad.reset()
    with torch.no_grad():
        assert torch.equal(ops.fused_gather_tokens(x, idx), gather_tokens_reference(x, idx))
        for rows in (x[:, :17].contiguous(), x[:, :17].float().contiguous()):
            assert torch.equal(ops.fused_scatter_tokens(rows, idx, 24),
                               scatter_tokens_reference(rows, idx, 24))
        for policy in (None, pol):
            chip_smoke.check_block(torch, x, w, H, scale, 1e-6, policy=policy)
            chip_smoke.check_block_backward(torch, x, g, w, H, scale, 1e-6, policy=policy)
        chip_smoke.check_cls_stage(torch, x, w, H, scale)
        xr = x.reshape(48, C)
        chip_smoke.check_ln_bwd(torch, (torch.randn((48, C), generator=gen, device=cuda), xr,
                                        norm_ops.ln_stats(xr, 1e-6), w["ln1_w"],
                                        g.reshape(48, C), False), 24, f"C={C}")
        chip_smoke.check_int8_block(torch, x, quant_ops.quantize_block_params(w), H, scale, 1e-6)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(C)
            pred = PredictorLG(C, small_predictor=True, use_fused=True)
        pw = pred.to(cuda).eval().kernel_weights(torch.bfloat16)
        chip_smoke.check_predictor(torch, x[:, 1:], pw, f"D={C}", "row_widths")
    counts = rowpad.counts()
    bf16_padded = C % 8 != 0
    assert counts.get("fused_gather_tokens", 0) == int(bf16_padded)
    assert counts.get("fused_transformer_block_backward", 0) == (2 if bf16_padded else 0)
    assert counts.get("fused_transformer_block_int8", 0) == (1 if C % 16 else 0)
    assert counts.get("fused_predictor_lg", 0) == (2 if any(c % 8 for c in (C, C // 2, C // 4))
                                                   else 0)

