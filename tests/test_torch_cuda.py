"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode) and
skip elsewhere; they import no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m gpu

Weights are drawn at N(0, 1/fan_in) rather than the init's std 0.02, so that
attention rows are peaked and the softmax is exercised. Tolerances are for
bf16 and relative to the largest magnitude of the plain output: the two
versions round to bf16 at different points.
"""

import pytest
import torch

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, create_model
from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.ops.block import transformer_block_reference
from dense2sparse_vit_torch.ops.gather import gather_tokens_reference
from dense2sparse_vit_torch.ops.predictor import predictor_lg_reference

pytestmark = pytest.mark.gpu
TOL = 2e-2


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


def _assert_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


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


# DeiT-S widths at the three stages, and DeiT-B's large predictor, whose
# first output unit takes 3072-wide rows
@pytest.mark.parametrize("d,small,n", [
    (384, True, 196), (384, True, 137), (384, True, 96),
    (384, False, 196), (384, False, 137), (384, False, 96), (768, False, 196),
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


def test_student_forward_launches_every_kernel(cuda):
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda,
                         **HEADLINE_KWARGS).eval()
    x = torch.randn((2, 224, 224, 3), device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "fused_transformer_block": 12, "fused_predictor_lg": 3,
        "fused_gather_tokens": 3,
    }
    assert out.logits.shape == (2, 1000) and out.features.shape == (2, 67, 384)
    assert int(out.kept_idx_orig.max()) < 196


def test_train_mode_launches_the_kernels_or_raises(cuda):
    """Train mode takes no plain path on the card: without autograd it
    launches the kernels, under autograd the wrappers raise."""
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=cuda,
                         **HEADLINE_KWARGS).train()
    x = torch.randn((2, 224, 224, 3), device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        model(x)
        torch.cuda.synchronize()
    assert ops.launch_counts() == {
        "fused_transformer_block": 12, "fused_predictor_lg": 3,
        "fused_gather_tokens": 3,
    }
    with pytest.raises(RuntimeError, match="no backward"):
        model(x)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 13, 384), device=cuda)  # fp32: the block kernel is bf16
    blk = Block(384, 6).to(cuda).eval()
    with torch.inference_mode(), pytest.raises(TypeError):
        ops.fused_transformer_block(x, blk.kernel_weights(torch.float32), 6)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_gather_tokens(
            x.requires_grad_(), torch.zeros((2, 3), dtype=torch.long, device=cuda))
