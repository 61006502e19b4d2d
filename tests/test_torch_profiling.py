"""The port's profiling helpers (`utils/profiling.py`) and the kernel sweep's
CPU smoke (`scripts/kernel_sweep.py --device cpu`).

FLOP counts are held to closed forms built from the modules' shapes (2 per
multiply-add of every matrix product and convolution), for the plain
student and for the one whose blocks and predictors run as the kernels'
custom ops; the latency breakdown's keys to the JAX package's, on a tiny
configuration on the CPU.
"""

import json
import os

import pytest
import torch

from dense2sparse_vit_torch.core import ModelConfig, PruningConfig
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.scripts import kernel_sweep
from dense2sparse_vit_torch.utils.profiling import (
    flops_of,
    latency_breakdown,
    pruned_vs_dense_flops,
    time_call,
    trace,
)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL = dict(img_size=32, patch_size=8, embed_dim=128, depth=4, num_heads=2, num_classes=10)
PRUNING = dict(pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True)
STUDENT = "dynamic_vit_small_patch16_224_student"


def test_flops_of_a_linear_layer():
    lin = torch.nn.Linear(48, 80)
    x = torch.randn(6, 48)
    assert flops_of(lin, x) == 2 * 6 * 48 * 80


@pytest.mark.parametrize("fused", [False, True])
def test_pruned_vs_dense_flops_is_the_closed_form(fused):
    """Patch embedding, the blocks at the widths they run at (17 tokens,
    then 1 + 11, then 1 + 7), the two predictors (pruned forward only) and
    the head; the fused student's custom ops count what the plain one's
    torch calls do."""
    student = create_model(STUDENT, device="cpu", use_fused_attention=fused, **MODEL,
                           **PRUNING).eval()
    B, D, n = 2, 128, 16
    images = torch.randn((B, 32, 32, 3), generator=torch.Generator().manual_seed(0))

    def block(w):
        return 2 * B * w * D * (4 * D + 2 * 4 * D) + 4 * B * w * w * D

    pred = sum(m.in_features * m.out_features for m in student.score_predictor[0].modules()
               if isinstance(m, torch.nn.Linear))
    base = 2 * B * n * D * 3 * 8 * 8 + 2 * B * D * 10  # patch conv, head
    dense = base + 4 * block(n + 1)
    pruned = (base + block(17) + block(12) + 2 * block(8)
              + 2 * B * (16 + 11) * pred)
    with torch.no_grad():
        got = pruned_vs_dense_flops(student, images, collect_cls_attns=False)
    assert got["pruned_gflops"] * 1e9 == pytest.approx(pruned, rel=1e-12)
    assert got["dense_gflops"] * 1e9 == pytest.approx(dense, rel=1e-12)
    assert got["flop_ratio"] == pytest.approx(pruned / dense, rel=1e-12)


def test_latency_breakdown_returns_the_jax_keys():
    """The keys the JAX package's `latency_breakdown` returns at the same
    configuration (`utils/profiling.py`: patch_embed_ms, one
    block_ms_at_{w}_tokens per width, here 17, 12 and 8, encoder_ms,
    predictor_ms, head_ms, total_ms), every time positive, the totals their
    sums. (Running the JAX function here would spend ~30 s compiling.)"""
    got = latency_breakdown(ModelConfig(**MODEL, use_fused_attention=True),
                            PruningConfig(**PRUNING), batch_size=2, iters=1, device="cpu")
    want = {"patch_embed_ms", "block_ms_at_17_tokens", "block_ms_at_12_tokens",
            "block_ms_at_8_tokens", "encoder_ms", "predictor_ms", "head_ms", "total_ms"}
    assert set(got) == want
    assert all(v > 0 for v in got.values())
    assert got["encoder_ms"] == pytest.approx(
        got["block_ms_at_17_tokens"] + got["block_ms_at_12_tokens"]
        + 2 * got["block_ms_at_8_tokens"])
    assert got["total_ms"] == pytest.approx(
        got["patch_embed_ms"] + got["encoder_ms"] + got["predictor_ms"] + got["head_ms"])


def test_time_call_on_the_cpu_counts_each_call():
    calls = []
    seconds = time_call(lambda: calls.append(1), iters=4, repeats=2, device="cpu")
    assert seconds >= 0 and len(calls) == 2 + 4 * 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.randn(8, 8) @ torch.randn(8, 8)
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_kernel_sweep_on_the_cpu_prints_its_rows(tmp_path, capsys):
    """--device cpu: every kernel's row at B=8, N=32, no MFU, the table
    written to --out."""
    out = tmp_path / "sweep.md"
    rows = kernel_sweep.main(["--device", "cpu", "--out", str(out)])
    kinds = ["attn_half_fwd", "attn_half_bwd", "attn_half_bwd[policy]", "mlp_half_fwd",
             "block_fwd", "block_bwd"]
    assert [r["kernel"] for r in rows] == kinds
    assert all(r["N"] == 32 and r["B"] == 8 and r["mfu"] is None and r["ms"] > 0 for r in rows)
    printed = capsys.readouterr().out
    table = out.read_text()
    for k in kinds:
        assert f"| {k} | 8 | 32 |" in printed and f"| {k} | 8 | 32 |" in table
    assert os.path.getsize(out) > 0
