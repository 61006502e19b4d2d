"""The int8 GEMM's plain version (`ops/quant.py::qgemm_reference`) against numpy.

On the CPU `qgemm` runs its plain version, which the card's tests
(`tests/test_torch_cuda.py`) hold the kernel against bit for bit. Here it is
held against the same function written in numpy: the exact int64 product,
converted to float32 and dequantized in float32, acc * (row_s * col_s) +
bias, plus the residual, each operation rounded on its own. Without GELU
the two give the same bits. Through GELU numpy takes the exact erf in
float64 and torch the fp32 one, so an element may land on the other side of
a bf16 rounding: within one bf16 rounding (2^-8 relative), beyond which
GELU_TOL of the output's largest magnitude.
"""

import json
import math

import numpy as np
import pytest
import torch

from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.ops.quant import qgemm, qgemm_reference, quant_block_reference
from dense2sparse_vit_torch.scripts import checkout_ab
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16_U = 2.0 ** -8
GELU_TOL = 1e-6
# option: (bias, residual dtype or None, gelu, out dtype)
OPTIONS = {
    "plain": (False, None, False, torch.bfloat16),
    "bias": (True, None, False, torch.bfloat16),
    "bias_f32_out": (True, None, False, torch.float32),
    "proj": (True, torch.bfloat16, False, torch.float32),
    "fc2": (True, torch.float32, False, torch.bfloat16),
    "residual_f32_out": (False, torch.float32, False, torch.float32),
    "fc1_gelu": (True, None, True, torch.bfloat16),
    "gelu_residual": (True, torch.bfloat16, True, torch.bfloat16),
}


def _inputs(seed, M, N, K, saturate=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (M, K), dtype=np.int8)
    if saturate:  # sums past 2^24, where the int32 -> fp32 conversion rounds
        codes[: M // 2] = 127
    w = rng.integers(-127, 128, (N, K), dtype=np.int8)
    w[0] = 127
    row_s = (rng.uniform(0.5, 2.0, M) / 127).astype(np.float32)
    col_s = (rng.uniform(0.5, 2.0, N) / 127 / math.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    residual = (4 * rng.standard_normal((M, N))).astype(np.float32)
    return codes, w, row_s, col_s, bias, residual


def _numpy_qgemm(codes, w, row_s, col_s, bias, residual, gelu):
    acc = codes.astype(np.int64) @ w.astype(np.int64).T
    v = acc.astype(np.float32) * (row_s[:, None] * col_s[None, :])
    if bias is not None:
        v = v + bias
    if gelu:
        u = torch.from_numpy(v).to(torch.bfloat16).float().numpy().astype(np.float64)
        v = (0.5 * u * (1 + np.vectorize(math.erf)(u / math.sqrt(2)))).astype(np.float32)
    if residual is not None:
        v = residual + v
    return torch.from_numpy(v)


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_qgemm_plain_version_against_numpy(option, saturate):
    has_bias, res_dtype, gelu, out_dtype = OPTIONS[option]
    M, N, K = 37, 24, 1536 if saturate else 96
    codes, w, row_s, col_s, bias, residual = _inputs(len(option) + saturate, M, N, K, saturate)
    res_t = None if res_dtype is None else torch.from_numpy(residual).to(res_dtype)
    got = qgemm(torch.from_numpy(codes), torch.from_numpy(row_s), torch.from_numpy(w),
                torch.from_numpy(col_s), bias=torch.from_numpy(bias) if has_bias else None,
                residual=res_t, gelu=gelu, out_dtype=out_dtype)
    want = _numpy_qgemm(codes, w, row_s, col_s, bias if has_bias else None,
                        None if res_t is None else res_t.float().numpy(), gelu).to(out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == (M, N)
    if not gelu:
        assert torch.equal(got, want)
        return
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - 2 * BF16_U * want.abs()).clamp(min=0)
    assert excess.max().item() <= GELU_TOL * want.abs().max().item()


def test_the_int8_blocks_products_are_qgemm_calls():
    """The plain int8 block's four stages are `qgemm` on its own codes and
    scales, bit for bit: qkv; x_mid = x + proj in fp32; GELU(fc1); the
    output x_mid + fc2."""
    C, H, B, N = 128, 2, 2, 9
    blk = Block(C, H, use_fused=True, quant="int8").eval()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / (p.shape[-1] ** 0.5 if p.dim() == 2
                                                           else 10))
    qw = blk.int8_weights(torch.bfloat16)
    x = torch.randn((B, N, C), generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        out, st = quant_block_reference(x, qw, H, blk.attn.scale, 1e-6, stages=True)

        def product(i, key, **kw):
            q = st[f"q{i}"]
            return qgemm(q.reshape(-1, q.shape[-1]), st[f"s{i}"].reshape(-1), qw[f"w{key}_q"],
                         qw[f"s{key}"], qw[f"b{key}"], **kw).reshape(B, N, -1)

        rows = (B * N, C)
        assert torch.equal(product(1, "qkv"), st["qkv"])
        assert torch.equal(product(2, "proj", residual=x.reshape(rows), out_dtype=torch.float32),
                           st["mid"])
        assert torch.equal(product(3, "1", gelu=True), st["act"])
        assert torch.equal(product(4, "2", residual=st["mid"].reshape(rows)), out)


def _valid():
    codes, w, row_s, col_s, bias, residual = _inputs(0, 5, 16, 32)
    return {"codes": torch.from_numpy(codes), "row_s": torch.from_numpy(row_s),
            "w_q": torch.from_numpy(w), "col_s": torch.from_numpy(col_s),
            "bias": torch.from_numpy(bias), "residual": torch.from_numpy(residual)}


REFUSALS = {
    "float_codes": ({"codes": torch.zeros(5, 32)}, TypeError),
    "codes_3d": ({"codes": torch.zeros(1, 5, 32, dtype=torch.int8)}, ValueError),
    "k_mismatch": ({"w_q": torch.zeros(16, 48, dtype=torch.int8)}, ValueError),
    "row_s_shape": ({"row_s": torch.ones(4)}, ValueError),
    "col_s_dtype": ({"col_s": torch.ones(16, dtype=torch.float64)}, ValueError),
    "bias_shape": ({"bias": torch.ones(15)}, ValueError),
    "residual_fp16": ({"residual": torch.zeros(5, 16, dtype=torch.float16)}, ValueError),
    "residual_shape": ({"residual": torch.zeros(5, 8)}, ValueError),
    "out_fp16": ({"out_dtype": torch.float16}, ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_qgemm_refuses_what_neither_version_takes(case):
    change, error = REFUSALS[case]
    kw = {**_valid(), **change}
    args = [kw.pop(k) for k in ("codes", "row_s", "w_q", "col_s")]
    with pytest.raises(error, match="qgemm"):
        qgemm(*args, **kw)


def test_checkout_ab_digests_and_compares_two_runs(tmp_path, capsys):
    """The script that compares two checkouts' bits, at its CPU smoke size:
    two runs give the same digests; one changed digest is reported."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert checkout_ab.main(["--device", "cpu", "--bits", str(a)]) == 0
    assert checkout_ab.main(["--device", "cpu", "--bits", str(b)]) == 0
    assert checkout_ab.main(["--compare", str(a), str(b)]) == 0
    run = json.loads(b.read_text())
    assert {k.split("/")[0] for k in run["digests"]} == {"int8", "gemm", "block", "block_bwd"}
    run["digests"]["int8/2x13x128/qkv"] = "0" * 64
    b.write_text(json.dumps(run))
    capsys.readouterr()
    assert checkout_ab.main(["--compare", str(a), str(b)]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["differ"] == 1
