"""The block checks of chip_smoke.py, on the CPU.

The check must pass a right block and reject one whose attention core is
wrong, even where the residual stream is far larger than the attention
branch (the init's weight scale, std 0.02), which is where a tolerance on
the block's whole output cannot see the fault. On the CPU the block wrapper
runs its plain version, so a fault is planted by handing that plain version
a wrong attention core for the duration of the wrapper's call.
"""

import json
import os
import sys

import pytest
import torch

import dense2sparse_vit_torch.ops.block as block_ops
import dense2sparse_vit_torch.ops.gemm as gemm_ops
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.nn.layers import Block, trunc_normal_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, N, C, H = 2, 13, 128, 2
_attention = block_ops.attention_reference  # the right one, for the faults


def _padded_keys(qkv, num_heads, scale):
    """Three zero keys (and values) enter every row's softmax."""
    pad = qkv.new_zeros((qkv.shape[0], 3, qkv.shape[2]))
    out = _attention(torch.cat([qkv, pad], 1), num_heads, scale)
    return out[:, : qkv.shape[1]]


def _wrong_head(qkv, num_heads, scale):
    """Each head multiplies its probabilities into the next head's values."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.split(c3 // 3, dim=-1)
    v = v.reshape(b, n, num_heads, -1).roll(1, dims=2).reshape(b, n, -1)
    return _attention(torch.cat([q, k, v], -1), num_heads, scale)


def _zero(qkv, num_heads, scale):
    return qkv.new_zeros((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


FAULTS = {"padded_keys": _padded_keys, "wrong_head": _wrong_head, "zero": _zero}


def _block_input():
    """A bf16 block at the init's scale, and a unit-scale residual stream."""
    g = torch.Generator().manual_seed(0)
    blk = Block(C, H, use_fused=True).eval()
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.dim() == 2:
                trunc_normal_(p, g)
            elif not name.endswith("norm1.weight") and not name.endswith("norm2.weight"):
                p.zero_()
    x = torch.randn((B, N, C), generator=g).to(torch.bfloat16)
    args = (H, blk.attn.scale, blk.norm1.eps)
    return x, blk.kernel_weights(torch.bfloat16), args


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_check_block_passes_the_plain_block(capsys):
    x, w, args = _block_input()
    with torch.inference_mode():
        y, err = chip_smoke.check_block(torch, x, w, *args, block=0)
    line = _last_line(capsys)
    assert err == 0.0 and y.shape == x.shape
    assert set(line["rel_err"]) == {"qkv", "attn", "hid", "mid", "out", "block"}
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_block_rejects_a_wrong_attention_core(monkeypatch, capsys, fault):
    real_block = ops.fused_transformer_block

    def faulty_block(*args, **kwargs):
        block_ops.attention_reference = FAULTS[fault]
        try:
            return real_block(*args, **kwargs)
        finally:
            block_ops.attention_reference = _attention

    monkeypatch.setattr(ops, "fused_transformer_block", faulty_block)
    x, w, args = _block_input()
    with torch.inference_mode(), pytest.raises(AssertionError, match="attn"):
        chip_smoke.check_block(torch, x, w, *args, block=0)
    line = _last_line(capsys)
    assert line["rel_err"]["attn"] > 2 * line["tol_rel"]["attn"]
    # the residual stages are held given the kernel's own attention output
    assert line["rel_err"]["mid"] <= line["tol_rel"]["mid"]


def test_check_block_rejects_a_wrong_residual_branch(monkeypatch):
    """A proj epilogue that drops its bias: the `mid` stage sees it."""
    real_block = ops.fused_transformer_block

    def faulty_block(x, w, *args, **kwargs):
        y, st = real_block(x, w, *args, **kwargs)
        st["mid"] = st["mid"] - w["bproj"].to(x.dtype)
        return y, st

    monkeypatch.setattr(ops, "fused_transformer_block", faulty_block)
    x, w, args = _block_input()
    w["bproj"] = torch.full_like(w["bproj"], 0.05)
    with torch.inference_mode(), pytest.raises(AssertionError, match="mid"):
        chip_smoke.check_block(torch, x, w, *args, block=0)


class _SoftmaxWithoutRowsum(torch.autograd.Function):
    """Softmax whose backward drops the rowsum(dP * P) term: the fault that
    chip_smoke.py --plant-fault puts into the block-backward kernel."""

    @staticmethod
    def forward(ctx, s):
        p = torch.softmax(s, dim=-1)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return p * g  # the right one is p * (g - (g * p).sum(-1, keepdim=True))


def _attention_without_rowsum(qkv, num_heads, scale):
    b, n, c3 = qkv.shape
    q, k, v = qkv.view(b, n, 3, num_heads, c3 // 3 // num_heads).permute(
        2, 0, 3, 1, 4).unbind(0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = _SoftmaxWithoutRowsum.apply(s).to(qkv.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, n, c3 // 3)


def _cotangent(x):
    return torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(x.dtype)


def test_check_block_backward_passes_the_plain_backward(capsys):
    x, w, args = _block_input()
    with torch.no_grad():
        err = chip_smoke.check_block_backward(torch, x, _cotangent(x), w, *args, block=0)
    line = _last_line(capsys)
    assert err == 0.0
    parts = {"wqkv.q", "wqkv.k", "wqkv.v", "bqkv.q", "bqkv.v"}
    assert set(line["rel_err"]) == {"dx", *parts, *w}


def test_check_block_backward_rejects_a_dropped_rowsum(monkeypatch, capsys):
    real = ops.fused_transformer_block_backward

    def faulty(*args, **kwargs):
        block_ops.attention_reference = _attention_without_rowsum
        try:
            return real(*args, **kwargs)
        finally:
            block_ops.attention_reference = _attention

    monkeypatch.setattr(ops, "fused_transformer_block_backward", faulty)
    x, w, args = _block_input()
    with torch.no_grad(), pytest.raises(AssertionError, match="wqkv.k"):
        chip_smoke.check_block_backward(torch, x, _cotangent(x), w, *args, block=0)
    line = _last_line(capsys)
    # the fault reaches only what flows through dQ and dK
    assert line["rel_err"]["w2"] == 0.0 and line["rel_err"]["wqkv.v"] == 0.0


# ---- the policy mode's checks ----------------------------------------------


def _keep_policy(n):
    pol = (torch.rand((B, n), generator=torch.Generator().manual_seed(2)) < 0.6).float()
    pol[:, 0] = 1.0
    return pol


@pytest.mark.parametrize("eps", chip_smoke.EPS_CHECKS)
def test_check_block_holds_the_policy_block(capsys, eps):
    x, w, args = _block_input()
    with torch.inference_mode():
        y, err = chip_smoke.check_block(torch, x, w, *args, block=3, policy=_keep_policy(N),
                                        eps=eps)
    line = _last_line(capsys)
    assert err == 0.0 and line["kernel"] == "fused_transformer_block[policy]"
    assert line["eps"] == eps
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])


def _faulty_softmax_with_policy(attn, policy, eps=1e-6):
    """The policy softmax whose dPolicy keeps the diagonal: the forward is
    the same, but a_jj = pol_j + (1 - pol_j) passes pol_j's gradient on.
    The fault chip_smoke.py --plant-fault policy puts into the kernel."""
    b, h, n, _ = attn.shape
    ap = policy.reshape(b, n)[:, None, None, :]
    ap = ap + (1.0 - ap.detach()) * torch.eye(n, dtype=ap.dtype)
    e = torch.exp((attn - torch.amax(attn, dim=-1, keepdim=True)).float()) * ap.float()
    return ((e + eps / n) / (e.sum(dim=-1, keepdim=True) + eps)).to(attn.dtype)


@pytest.mark.parametrize("eps", chip_smoke.EPS_CHECKS)
def test_check_block_backward_holds_dpolicy(capsys, eps):
    x, w, args = _block_input()
    with torch.no_grad():
        err = chip_smoke.check_block_backward(torch, x, _cotangent(x), w, *args, block=3,
                                              policy=_keep_policy(N), eps=eps)
    line = _last_line(capsys)
    assert err == 0.0 and line["kernel"] == "fused_transformer_block_backward[policy]"
    assert "dpolicy" in line["rel_err"] and line["dpolicy_tol_rel"] == chip_smoke.DPOL_TOL


@pytest.mark.parametrize("eps", chip_smoke.EPS_CHECKS)
def test_check_block_backward_rejects_dpolicy_with_its_diagonal(monkeypatch, capsys, eps):
    real = ops.fused_transformer_block_backward
    right = block_ops.softmax_with_policy

    def faulty(*args, **kwargs):
        block_ops.softmax_with_policy = _faulty_softmax_with_policy
        try:
            return real(*args, **kwargs)
        finally:
            block_ops.softmax_with_policy = right

    monkeypatch.setattr(ops, "fused_transformer_block_backward", faulty)
    x, w, args = _block_input()
    with torch.no_grad(), pytest.raises(AssertionError, match="dpolicy"):
        chip_smoke.check_block_backward(torch, x, _cotangent(x), w, *args, block=3,
                                        policy=_keep_policy(N), eps=eps)
    line = _last_line(capsys)
    # the fault reaches dPolicy alone
    assert line["rel_err"]["dpolicy"] > 2 * chip_smoke.DPOL_TOL
    assert all(v == 0.0 for k, v in line["rel_err"].items() if k != "dpolicy")


def test_the_planted_faults_are_in_the_kernel_source_once():
    for source, pattern, replacement, _ in chip_smoke.FAULTS.values():
        src = open(os.path.join(REPO, "dense2sparse_vit_torch", "csrc", source)).read()
        assert src.count(pattern) == 1 and replacement not in src


def test_planted_ties_reach_row_maxima():
    x, w, args = _block_input()
    with torch.no_grad():
        x_tie, tied = chip_smoke.planted_ties(torch, x, w, *args)
    assert tied > 0 and x_tie.shape == x.shape


# ---- the int8 block's check ------------------------------------------------


def _int8_input():
    x, _, args = _block_input()
    blk = Block(C, H, use_fused=True, quant="int8").eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                    / (p.shape[-1] ** 0.5 if p.dim() == 2 else 10))
        blk.norm1.weight.add_(1)
        blk.norm2.weight.add_(1)
    return x, blk.int8_weights(torch.bfloat16), args


def test_check_int8_block_passes_the_plain_block(capsys):
    x, qw, args = _int8_input()
    with torch.inference_mode():
        y, err = chip_smoke.check_int8_block(torch, x, qw, *args, block=0)
    line = _last_line(capsys)
    assert err == 0.0 and y.shape == x.shape
    assert set(line["rel_err"]) == {"x_mid", "qkv", "act", "fc2_out", "attn", "block"}
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])
    assert all(c["share"] == 0.0 for c in line["codes"].values())


def test_check_int8_block_rejects_fc2_with_fc1_scales(monkeypatch, capsys):
    """The fault chip_smoke.py --plant-fault int8 plants in the kernel: fc2
    dequantized with fc1's column scales. Only the fc2 stage sees it; the
    whole output, at this weight scale, may not."""
    real = ops.fused_transformer_block_int8

    def faulty(x, qw, *args, **kwargs):
        return real(x, {**qw, "s2": qw["s1"][: qw["s2"].shape[0]]}, *args, **kwargs)

    monkeypatch.setattr(ops, "fused_transformer_block_int8", faulty)
    x, qw, args = _int8_input()
    with torch.inference_mode(), pytest.raises(AssertionError, match="fc2_out"):
        chip_smoke.check_int8_block(torch, x, qw, *args, block=0)
    line = _last_line(capsys)
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in ("qkv", "x_mid", "act", "attn"))


def test_check_int8_block_rejects_a_shifted_code(monkeypatch):
    """Codes of the attention output off by one step where the plain
    quantization of the same rows must agree exactly."""
    real = ops.fused_transformer_block_int8

    def faulty(*args, **kwargs):
        y, st = real(*args, **kwargs)
        st["q2"] = st["q2"].clone()
        st["q2"][0, 0, 0] += 1
        return y, st

    monkeypatch.setattr(ops, "fused_transformer_block_int8", faulty)
    x, qw, args = _int8_input()
    with torch.inference_mode(), pytest.raises(AssertionError, match="codes2"):
        chip_smoke.check_int8_block(torch, x, qw, *args, block=0)


def test_int8_walk_equals_the_forward():
    """chip_smoke.walk_int8 (the forward stage by stage, every block
    checked) gives the int8 student's logits, on a tiny student."""
    from dense2sparse_vit_torch.models import create_model

    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu", img_size=32,
                         patch_size=8, embed_dim=C, depth=3, num_heads=H, num_classes=10,
                         pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True,
                         dtype="bfloat16", use_fused_attention=True, quant="int8").eval()
    images = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        logits, shapes = chip_smoke.walk_int8(torch, model, images.to(torch.bfloat16))
        want = model(images.to(torch.bfloat16), collect_cls_attns=False).logits
    assert torch.equal(logits, want)
    assert [x.shape[1] for x, _, _, _ in shapes] == [17, 12, 8]


# ---- the packed attention's and the MLP half's checks ----------------------


def _attn_case(gcls=True):
    """A train step's record at one block, as chip_smoke.capture_attn_step
    keeps it: the packed core's qkv and cotangents, the MLP half's input,
    weights and cotangent (bf16 activations, fp32 LayerNorm and biases)."""
    g = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g) * s

    e = {"qkv": rnd(B, N, 3 * C).to(bf16), "heads": H, "scale": (C // H) ** -0.5,
         "g": rnd(B, N, C).to(bf16), "gcls": rnd(B, H, N, s=0.1).to(bf16) if gcls else None}
    w = [1 + rnd(C, s=0.1), rnd(C, s=0.1), rnd(4 * C, C, s=C ** -0.5).to(bf16),
         rnd(4 * C, s=0.1), rnd(C, 4 * C, s=(4 * C) ** -0.5).to(bf16), rnd(C, s=0.1)]
    m = {"x": rnd(B, N, C).to(bf16), "w": w, "eps": 1e-6, "g": rnd(B, N, C).to(bf16)}
    return e, m


@pytest.mark.parametrize("gcls", [True, False])
def test_check_attn_block_passes_the_plain_versions(capsys, gcls):
    e, m = _attn_case(gcls)
    worst = chip_smoke.check_attn_block(torch, e, m, block=2)
    line = _last_line(capsys)
    assert all(v == 0.0 for v in worst.values())
    folds = {f"gcls_only[{k}].{p}" for k in ("step", "offset") for p in "qkv"}
    assert folds <= set(line["rel_err"]) if gcls else not folds & set(line["rel_err"])
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])


def _fold_without_cls_mass(real):
    """The packed backward whose CLS fold leaves sum_j gcls_j P_0j out of
    D_0: the fault chip_smoke.py --plant-fault cls puts into the kernel.
    Every dS_0j = P_0j (dP_0j - D_0) then gains P_0j sum_k gcls_k P_0k."""

    def faulty(qkv, g, num_heads, *, gcls=None, scale=None, **kwargs):
        right = real(qkv, g, num_heads, gcls=gcls, scale=scale, **kwargs)
        if gcls is None:
            return right
        b, n, c3 = qkv.shape
        q, k, _ = qkv.float().view(b, n, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
        p0 = torch.softmax(q[:, :, :1] @ k.transpose(-1, -2) * scale, dim=-1)[:, :, 0]
        ds0 = p0 * (gcls.float() * p0).sum(-1, keepdim=True)  # (b, h, n)
        extra = torch.zeros((b, n, 3, num_heads, c3 // 3 // num_heads))
        extra[:, 0, 0] = scale * (ds0[..., None] * k).sum(2)
        extra[:, :, 1] = (scale * ds0[..., None] * q[:, :, :1]).permute(0, 2, 1, 3)
        return (right.float() + extra.reshape(b, n, c3)).to(right.dtype)

    return faulty


def test_check_attn_block_rejects_the_fold_without_its_mass(monkeypatch, capsys):
    monkeypatch.setattr(ops, "fused_attention_backward_packed",
                        _fold_without_cls_mass(ops.fused_attention_backward_packed))
    e, m = _attn_case()
    with pytest.raises(AssertionError, match=r"gcls_only\[offset\]"):
        chip_smoke.check_attn_block(torch, e, m, block=2)
    line = _last_line(capsys)
    assert line["rel_err"]["gcls_only[offset].k"] > 2 * chip_smoke.BWD_TOL
    # the forward, the values' gradient and the MLP half do not see it
    assert all(v == 0.0 for k, v in line["rel_err"].items()
               if k in ("out", "cls") or k.endswith(".v") or k.startswith("mlp."))


@pytest.mark.parametrize("eps", chip_smoke.EPS_CHECKS)
def test_check_attn_policy_passes_the_plain_versions(capsys, eps):
    e, _ = _attn_case()
    chip_smoke.check_attn_policy(torch, e["qkv"], _keep_policy(N), e["g"], e["gcls"], H,
                                 e["scale"], eps)
    line = _last_line(capsys)
    assert line["eps"] == eps and "dpolicy" in line["rel_err"]
    assert all(v == 0.0 for v in line["rel_err"].values())


# ---- the DropPath branch scales' check ------------------------------------


def _droppath_case():
    """A two-block stand-in for a T2T step's capture: block 0 without
    DropPath, block 1 with it, each at the init's weight scale, and its
    input, weights and the step's last cotangent."""
    x, w, _ = _block_input()
    blocks = [Block(C, H, use_fused=True), Block(C, H, drop_path=0.1, use_fused=True)]
    student = torch.nn.Module()
    student.blocks = torch.nn.ModuleList(blocks)
    rec = {"block_in": {0: x, 1: x}, "weights": {0: w, 1: w}, "last_g": _cotangent(x)}
    return student, rec


def test_check_droppath_passes_the_plain_versions(capsys):
    student, rec = _droppath_case()
    chip_smoke.check_droppath(torch, torch.device("cpu"), student, rec)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    # block 1 alone, plain and policy mode, each way
    assert [ln["kernel"] for ln in lines] == [
        "fused_transformer_block[scaled]", "fused_transformer_block_backward[scaled]"] * 2
    assert all(ln["block"] == 1 for ln in lines) and "eps" in lines[2]
    assert all(v <= lines[0]["tol_rel"][k] for k, v in lines[0]["rel_err"].items())


def test_check_droppath_rejects_kernels_that_ignore_the_scales(monkeypatch, capsys):
    """The fault chip_smoke.py --plant-fault droppath puts into the residual
    GEMM's epilogue: the branches unscaled. Zero scales leave whole branches
    out, which the residual stage sees."""
    for name in ("fused_transformer_block", "fused_transformer_block_backward"):
        real = getattr(ops, name)

        def unscaled(*args, branch_scales=None, _real=real, **kwargs):
            return _real(*args, **kwargs)

        monkeypatch.setattr(ops, name, unscaled)
    student, rec = _droppath_case()
    with pytest.raises(AssertionError, match="mid"):
        chip_smoke.check_droppath(torch, torch.device("cpu"), student, rec)
    line = _last_line(capsys)
    assert line["kernel"] == "fused_transformer_block[scaled]"
    assert line["rel_err"]["mid"] > 2 * chip_smoke.BRANCH_TOL


# ---- the attention half-block's and the variants' checks --------------------


def _half_block_input():
    """A bf16 half-block at the init's scale (the `_block_input` block's LN1,
    qkv and proj weights) and its unit-scale input."""
    x, w, args = _block_input()
    return x, [w[k] for k in chip_smoke.HALF_BLOCK_KEYS], args


@pytest.mark.parametrize("mode", ["plain", "policy", "cls"])
def test_check_attn_half_passes_the_plain_half_block(capsys, mode):
    x, w6, args = _half_block_input()
    kw = {"policy": _keep_policy(N), "eps": 0.1} if mode == "policy" else {}
    with torch.no_grad():
        err = chip_smoke.check_attn_half(torch, x, w6, *args, block=0, cls=mode == "cls", **kw)
    line = _last_line(capsys)
    assert err == 0.0
    stages = {"qkv", "attn", "out", "block"} | ({"cls", "cls_rowsum"} if mode == "cls" else set())
    assert set(line["rel_err"]) == stages
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])


def test_check_attn_half_rejects_a_wrong_attention_core(monkeypatch):
    """The core far smaller than the residual: the staged check sees a wrong
    head's values that a tolerance on the output would not."""
    import dense2sparse_vit_torch.ops.attention as attn_ops

    real = ops.fused_attention_block

    def faulty(*args, **kwargs):
        attn_ops.attention_reference = lambda qkv, h, scale, **kw: _wrong_head(qkv, h, scale)
        try:
            return real(*args, **kwargs)
        finally:
            attn_ops.attention_reference = _attention

    monkeypatch.setattr(ops, "fused_attention_block", faulty)
    x, w6, args = _half_block_input()
    with torch.no_grad(), pytest.raises(AssertionError, match="attn"):
        chip_smoke.check_attn_half(torch, x, w6, *args, block=0)


@pytest.mark.parametrize("policy", [False, True])
def test_check_attn_half_backward_passes_the_plain_backward(capsys, policy):
    x, w6, args = _half_block_input()
    kw = {"policy": _keep_policy(N), "eps": 0.1} if policy else {}
    with torch.no_grad():
        err = chip_smoke.check_attn_half_backward(torch, x, _cotangent(x), w6, *args, block=0,
                                                  **kw)
    line = _last_line(capsys)
    assert err == 0.0
    names = {"dx", "ln_w", "ln_b", "wqkv", "bqkv", "wproj", "bproj",
             "wqkv.q", "wqkv.k", "wqkv.v", "bqkv.q", "bqkv.v"}
    assert set(line["rel_err"]) == names | ({"dpolicy"} if policy else set())


def test_check_attn_half_backward_rejects_dx_without_g_on_row_0(monkeypatch, capsys):
    """The fault --plant-fault attn_block puts into the kernel: dx leaves out
    the residual cotangent g on row 0 of each sample."""
    real = ops.fused_attention_block_backward

    def faulty(x, g, *args, **kwargs):
        dx, *rest = real(x, g, *args, **kwargs)
        dx = dx.clone()
        dx[:, 0] -= g[:, 0]
        return (dx, *rest)

    monkeypatch.setattr(ops, "fused_attention_block_backward", faulty)
    x, w6, args = _half_block_input()
    with torch.no_grad(), pytest.raises(AssertionError, match=chip_smoke.FAULTS["attn_block"][3]):
        chip_smoke.check_attn_half_backward(torch, x, _cotangent(x), w6, *args, block=0)
    line = _last_line(capsys)
    assert all(v == 0.0 for k, v in line["rel_err"].items() if k != "dx")


def _variant_input():
    from dense2sparse_vit_torch.scripts import attn_variants

    params = attn_variants.make_params(C, "cpu")
    return attn_variants.make_input(B, N, C, "cpu"), params


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_check_variant_passes_the_plain_versions(capsys, variant):
    x, params = _variant_input()
    with torch.no_grad():
        err = chip_smoke.check_variant(torch, variant, x, params, H)
    line = _last_line(capsys)
    assert err == 0.0 and line["variant"] == variant
    assert all(line["rel_err"][k] <= line["tol_rel"][k] for k in line["rel_err"])


def _head_a_twice(qkv, num_heads, scale):
    """v2 with head b's scores recovered as (S+ + S-) / 2, head a's: the
    fault --plant-fault variant puts into the kernel."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.split(c3 // 3, dim=-1)
    d = c3 // 3 // num_heads
    q = q.reshape(b, n, num_heads // 2, 2, d)
    k = k.reshape(b, n, num_heads // 2, 2, d)
    q, k = q[:, :, :, :1].expand_as(q), k[:, :, :, :1].expand_as(k)
    return _attention(torch.cat([q.reshape(b, n, -1), k.reshape(b, n, -1), v], -1), num_heads,
                      scale)


def test_the_variants_check_rejects_v2_with_head_a_scores_twice(monkeypatch):
    import dense2sparse_vit_torch.ops.attention as attn_ops

    real = ops.fused_attention_variant
    right = attn_ops.paired_attention_reference

    def faulty(*args, **kwargs):
        attn_ops.paired_attention_reference = _head_a_twice
        try:
            return real(*args, **kwargs)
        finally:
            attn_ops.paired_attention_reference = right

    monkeypatch.setattr(ops, "fused_attention_variant", faulty)
    x, params = _variant_input()
    with torch.no_grad(), pytest.raises(AssertionError, match="v2 N="):
        chip_smoke.check_variant(torch, 2, x, params, H)


def test_check_block_rejects_a_qkv_short_of_its_last_k_slice(monkeypatch, capsys):
    """The qkv product without its last 64-deep K slice, what
    `--plant-fault gemm` does to every product of the GEMM engine: the qkv
    stage sees it."""
    real_block = ops.fused_transformer_block

    def faulty_block(x, w, *args, **kwargs):
        y, st = real_block(x, w, *args, **kwargs)
        h = block_ops.layer_norm(x, w["ln1_w"], w["ln1_b"], 1e-6)[..., :-64]
        st["qkv"] = block_ops.linear(h, w["wqkv"][:, :-64].contiguous(), w["bqkv"])
        return y, st

    monkeypatch.setattr(ops, "fused_transformer_block", faulty_block)
    x, w, args = _block_input()
    with torch.inference_mode(), pytest.raises(AssertionError, match="qkv"):
        chip_smoke.check_block(torch, x, w, *args, block=0)
    line = _last_line(capsys)
    assert line["rel_err"]["qkv"] > 2 * line["tol_rel"]["qkv"]


# mangled names of the engine's instantiations: bf16 modes 0 and 2, int8
BF16_NK = "_ZN3d2s11gemm_kernelILi0E13__nv_bfloat16EEv14CUtensorMap_stS2_NS_9GemmArgsTIS1_EE"
BF16_WG = "_ZN3d2s11gemm_kernelILi2E13__nv_bfloat16EEv14CUtensorMap_stS2_NS_9GemmArgsTIS1_EE"
INT8_NK = "_ZN3d2s11gemm_kernelILi0EaEEv14CUtensorMap_stS1_NS_9GemmArgsTIaEENS_9GemmTilesE"


def test_gemm_spills_reads_each_gemm_kernels_ptxas_line():
    log = "\n".join([
        f"ptxas info    : Function properties for {BF16_NK}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Function properties for _ZN3d2s12rowq_kernelIfLi2EEEvPKT_",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        f"ptxas info    : Function properties for {BF16_WG}",
        "    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        f"ptxas info    : Function properties for {INT8_NK}",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
    ])
    spills = chip_smoke.gemm_spills(log)
    assert sorted(spills) == sorted([BF16_NK, BF16_WG, INT8_NK])
    assert spills[BF16_WG].startswith("16 bytes stack")
    assert spills[INT8_NK].startswith("0 bytes stack frame, 4 bytes spill stores")
    assert chip_smoke.gemm_kernel_kind(INT8_NK) == ("0", "int8")
    assert chip_smoke.gemm_kernel_kind(BF16_WG) == ("2", "bf16")


def _sass(**ops):
    return {**dict.fromkeys(chip_smoke.SASS_OPS, 0), **ops}


def test_gemm_sass_faults_hold_every_engine_kernel_to_its_wgmma():
    """The library's GEMM kernels: the engine's three bf16 modes with HGMMA,
    its int8 one with IGMMA, no mma.sync (HMMA, IMMA) and nothing else."""
    good = {BF16_NK: _sass(HGMMA=28), BF16_NK.replace("ILi0", "ILi1"): _sass(HGMMA=28),
            BF16_WG: _sass(HGMMA=28), INT8_NK: _sass(IGMMA=16)}
    assert chip_smoke.gemm_sass_faults(good) == []
    for name, bad in ((INT8_NK, _sass(IGMMA=16, IMMA=4)), (INT8_NK, _sass(HGMMA=16)),
                      (BF16_WG, _sass(HGMMA=28, HMMA=2)), (BF16_NK, _sass(IGMMA=28))):
        faults = chip_smoke.gemm_sass_faults({**good, name: bad})
        assert len(faults) == 1 and name in faults[0], (name, bad)
    without_int8 = {k: v for k, v in good.items() if k != INT8_NK}
    assert chip_smoke.gemm_sass_faults(without_int8) == ["missing ('0', 'int8')"]
    old = "_ZN3d2s12qgemm_kernelENS_9QGemmArgsE"
    assert chip_smoke.gemm_sass_faults({**good, old: _sass(IMMA=32)}) == [
        f"not an engine kernel: {old}"]


def test_the_qgemm_fault_reaches_the_int8_products_alone():
    """`--plant-fault qgemm` edits the s8 product call, which only the
    int8 instantiation's branch of the engine's consumer loop holds."""
    source, pattern, replacement, reaches = chip_smoke.FAULTS["qgemm"]
    lines = open(os.path.join(REPO, "dense2sparse_vit_torch", "csrc", source)).read().splitlines()
    at = [i for i, ln in enumerate(lines) if pattern in ln]
    assert len(at) == 1 and lines[at[0] - 1].strip() == "if constexpr (INT8) {"
    assert replacement.startswith("if (kb + 1 < slices) ") and reaches == "'qkv'"


def test_check_int8_block_rejects_a_qkv_short_of_its_last_k_slice(monkeypatch, capsys):
    """The qkv product without its last 128-value K slice, what
    `--plant-fault qgemm` does to every int8 product: the qkv stage sees it."""
    from dense2sparse_vit_torch.ops.quant import qgemm

    real = ops.fused_transformer_block_int8

    def faulty(x, qw, *args, **kwargs):
        y, st = real(x, qw, *args, **kwargs)
        q = st["q1"].clone()
        q[..., -128:] = 0
        st["qkv"] = qgemm(q.reshape(-1, C), st["s1"].reshape(-1), qw["wqkv_q"], qw["sqkv"],
                          qw["bqkv"]).reshape(st["qkv"].shape)
        return y, st

    monkeypatch.setattr(ops, "fused_transformer_block_int8", faulty)
    x, qw, args = _int8_input()
    with torch.inference_mode(), pytest.raises(AssertionError, match=chip_smoke.FAULTS["qgemm"][3]):
        chip_smoke.check_int8_block(torch, x, qw, *args, block=0)
    line = _last_line(capsys)
    assert line["rel_err"]["qkv"] > 2 * line["tol_rel"]["qkv"]


def _norm_cases():
    """Phase 29's inputs at a small block: its two LayerNorm backwards' and
    four bias sums' inputs from plain autograd, one width."""
    x, w, (heads, scale, ln_eps) = _block_input()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(29)).to(x.dtype)
    inputs = chip_smoke.norm_inputs(torch, x, g, w, heads, scale, ln_eps)
    return [(x.shape[1], 1, inputs)]


def test_check_norm_passes_the_plain_versions(capsys):
    cases = _norm_cases()
    (_, _, inputs), = cases
    assert [c[0].dtype for c in inputs["ln"].values()] == [torch.float32] * 2
    assert inputs["ln"]["ln2"][4].dtype == torch.bfloat16  # the residual g
    assert inputs["ln"]["ln1"][4].dtype == torch.float32  # dx_mid
    assert {k: a.shape[1] for k, a in inputs["sums"].items()} == {
        "g": C, "dy": 4 * C, "dqkv": 3 * C, "da": C}
    with torch.no_grad():
        chip_smoke.check_norm(torch, cases)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["kernel"] for ln in lines] == ["ln_bwd"] * 2 + ["column_sums"] * 4 + \
        ["wgrad+bias"] * 3
    assert all(ln.get("dx_rel_err", 0.0) == 0.0 and ln.get("rel_err", 0.0) == 0.0
               for ln in lines)


def test_check_norm_rejects_ln_bwd_without_its_mean_dz_z_term(monkeypatch):
    """`--plant-fault ln_bwd`: dx = rstd (dz - mean dz), the z mean(dz z)
    term dropped."""
    import dense2sparse_vit_torch.ops.norm as norm_ops

    def faulty(dy, x, st, ln_w, residual=None, fp32_copy=False):
        dx, dx_f, d_w, d_b = norm_ops.ln_backward_reference(dy, x, st, ln_w, residual, True)
        z = (x.float() - st[:, :1]) * st[:, 1:]
        dz = dy * ln_w
        dx_f = dx_f + st[:, 1:] * z * (dz * z).mean(-1, keepdim=True)
        return (dx_f.to(torch.bfloat16), dx_f, d_w, d_b) if fp32_copy else (
            dx_f.to(torch.bfloat16), d_w, d_b)

    monkeypatch.setattr(norm_ops, "ln_backward", faulty)
    cases = _norm_cases()
    with torch.no_grad(), pytest.raises(AssertionError, match=chip_smoke.FAULTS["ln_bwd"][3]):
        chip_smoke.check_norm(torch, cases)


def test_check_norm_rejects_column_sums_without_the_last_rows(monkeypatch):
    """`--plant-fault colsum`: the column sums leave out the last split's
    rows (here the last 8)."""
    import dense2sparse_vit_torch.ops.norm as norm_ops

    monkeypatch.setattr(norm_ops, "column_sums",
                        lambda a: norm_ops.column_sums_reference(a[:-8]))
    cases = _norm_cases()
    with torch.no_grad(), pytest.raises(AssertionError, match=chip_smoke.FAULTS["colsum"][3]):
        chip_smoke.check_norm(torch, cases)


def test_check_norm_rejects_folded_bias_sums_that_move_dw(monkeypatch):
    """The weight gradient's folded bias sums must leave dW's bits alone."""
    real = gemm_ops.weight_grad

    def faulty(p, q, bias=False):
        if not bias:
            return real(p, q)
        dw, db = real(p, q, bias=True)
        return dw * (1 + 2.0 ** -20), db

    monkeypatch.setattr(gemm_ops, "weight_grad", faulty)
    cases = _norm_cases()
    with torch.no_grad(), pytest.raises(AssertionError, match="wgrad bias sums"):
        chip_smoke.check_norm(torch, cases)


# ---- the attention core backward's check (phase 30) -----------------------

CORE_N = 80  # two key blocks of the kernel's 64, the last one short


def _core_case(what="topk", eps=1e-6, n=CORE_N):
    """A phase-30 case at a small size (B=2, C=128, 2 heads): seeded qkv and
    the attention output's cotangent; a keep policy for "threshold", the CLS
    rows' cotangent for "gcls"."""
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn((B, n, 3 * C), generator=gen).to(torch.bfloat16)
    g = torch.randn((B, n, C), generator=gen).to(torch.bfloat16)
    return {"what": what, "block": 0, "qkv": qkv, "g": g, "heads": H,
            "scale": (C // H) ** -0.5, "eps": eps,
            "policy": _keep_policy(n) if what == "threshold" else None,
            "gcls": torch.randn((B, H, n), generator=gen) if what == "gcls" else None}


@pytest.mark.parametrize("what,eps", [("topk", 1e-6), ("threshold", 1e-6), ("threshold", 0.1),
                                      ("gcls", 1e-6)])
def test_check_attn_bwd_passes_the_plain_version(capsys, what, eps):
    err = chip_smoke.check_attn_bwd(torch, _core_case(what, eps))
    line = _last_line(capsys)
    assert err == 0.0 and line["bit_equal"] and line["case"] == what
    assert set(line["rel_err"]) == {"dqkv.q", "dqkv.k", "dqkv.v"} | (
        {"dpolicy"} if what == "threshold" else set())
    assert all(v == 0.0 for v in line["rel_err"].values())


def _without_last_key_block(real):
    """The packed backward whose dQ leaves out the last 64-key block's
    products, what `--plant-fault attn_bwd` does to the kernel (plain
    mode): dQ_i loses scale sum_{j in the block} dS_ij k_j."""

    def faulty(qkv, g, num_heads, *, gcls=None, scale=None, **kwargs):
        right = real(qkv, g, num_heads, gcls=gcls, scale=scale, **kwargs)
        b, n, c3 = qkv.shape
        q, k, v = qkv.float().view(b, n, 3, num_heads, -1).permute(2, 0, 3, 1, 4)
        p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
        dp = g.float().view(b, n, num_heads, -1).transpose(1, 2) @ v.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        last = (n - 1) // 64 * 64
        lost = (ds[..., last:] @ k[:, :, last:]).transpose(1, 2).reshape(b, n, c3 // 3)
        return torch.cat([(right[..., :c3 // 3].float() - lost).to(right.dtype),
                          right[..., c3 // 3:]], -1)

    return faulty


def test_check_attn_bwd_rejects_a_dq_without_its_last_key_block(monkeypatch, capsys):
    monkeypatch.setattr(ops, "fused_attention_backward_packed",
                        _without_last_key_block(ops.fused_attention_backward_packed))
    with pytest.raises(AssertionError, match=chip_smoke.FAULTS["attn_bwd"][3]):
        chip_smoke.check_attn_bwd(torch, _core_case())
    line = _last_line(capsys)
    # dQ alone: the keys' and values' gradients do not see it
    assert line["rel_err"]["dqkv.q"] > 2 * chip_smoke.BWD_TOL
    assert line["rel_err"]["dqkv.k"] == 0.0 and line["rel_err"]["dqkv.v"] == 0.0


@pytest.mark.parametrize("eps", chip_smoke.EPS_CHECKS)
def test_check_attn_bwd_rejects_dpolicy_with_its_diagonal(monkeypatch, capsys, eps):
    real = ops.fused_attention_backward_packed
    right = block_ops.softmax_with_policy

    def faulty(*args, **kwargs):
        block_ops.softmax_with_policy = _faulty_softmax_with_policy
        try:
            return real(*args, **kwargs)
        finally:
            block_ops.softmax_with_policy = right

    monkeypatch.setattr(ops, "fused_attention_backward_packed", faulty)
    with pytest.raises(AssertionError, match="dpolicy"):
        chip_smoke.check_attn_bwd(torch, _core_case("threshold", eps))
    line = _last_line(capsys)
    assert line["rel_err"]["dpolicy"] > 2 * chip_smoke.DPOL_TOL
    assert all(v == 0.0 for k, v in line["rel_err"].items() if k != "dpolicy")


def test_check_attn_bwd_rejects_two_launches_that_differ(monkeypatch, capsys):
    real = ops.fused_attention_backward_packed
    calls = []

    def drifting(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        return out if len(calls) == 1 else out + torch.finfo(torch.bfloat16).eps * out

    monkeypatch.setattr(ops, "fused_attention_backward_packed", drifting)
    with pytest.raises(AssertionError, match="bit-equal: False"):
        chip_smoke.check_attn_bwd(torch, _core_case())
    assert _last_line(capsys)["bit_equal"] is False


def test_attn_bwd_inputs_are_the_block_backward_s(monkeypatch):
    """qkv and dO from `attn_bwd_inputs` are what autograd through the whole
    plain block hands its attention core."""
    x, w, (heads, scale, ln_eps) = _block_input()
    g = _cotangent(x)
    qkv, do = chip_smoke.attn_bwd_inputs(torch, x, g, w, heads, scale, ln_eps)
    seen = {}
    real = block_ops.attention_reference

    def spy(qkv_in, *args, **kwargs):
        out = real(qkv_in, *args, **kwargs)
        seen["qkv"] = qkv_in.detach()
        out.retain_grad()
        seen["out"] = out
        return out

    monkeypatch.setattr(block_ops, "attention_reference", spy)
    with torch.enable_grad():
        xx = x.clone().requires_grad_()
        block_ops.transformer_block_reference(xx, w, heads, scale, ln_eps).backward(g)
    assert torch.equal(qkv, seen["qkv"])
    assert torch.equal(do, seen["out"].grad)


ATTN_BWD_PLAIN = "_ZN3d2sL20attention_bwd_kernelILb0ELi1EEEv14CUtensorMap_stS1_PK13__nv_bfloat16"
ATTN_BWD_POLICY = ATTN_BWD_PLAIN.replace("ILb0ELi1E", "ILb1ELi1E")


def test_attn_bwd_kind_reads_the_instantiations():
    assert chip_smoke.attn_bwd_kind(ATTN_BWD_PLAIN) == (False, 1)
    assert chip_smoke.attn_bwd_kind(ATTN_BWD_POLICY.replace("Li1E", "Li2E")) == (True, 2)
    assert chip_smoke.attn_bwd_kind(BF16_NK) is None
    log = "\n".join([f"ptxas info    : Function properties for {ATTN_BWD_PLAIN}",
                     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                     f"ptxas info    : Function properties for {BF16_NK}",
                     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"])
    assert list(chip_smoke.gemm_spills(log, "attention_bwd_kernel")) == [ATTN_BWD_PLAIN]


def test_attn_bwd_sass_faults_hold_each_instantiation_to_wgmma():
    """Every instantiation with HGMMA; HMMA (the tie test's mma.sync
    scores) in the policy-mode ones alone; all four present."""
    names = {k: ATTN_BWD_PLAIN.replace("ILb0ELi1E", f"ILb{int(k[0])}ELi{k[1]}E")
             for k in chip_smoke.ATTN_BWD_KERNELS}
    good = {n: _sass(HGMMA=40, HMMA=32 if k[0] else 0) for k, n in names.items()}
    assert chip_smoke.attn_bwd_sass_faults(good) == []
    plain = names[(False, 1)]
    for bad in (_sass(HGMMA=40, HMMA=2), _sass(HMMA=64), _sass(HGMMA=40, IMMA=1)):
        faults = chip_smoke.attn_bwd_sass_faults({**good, plain: bad})
        assert len(faults) == 1 and plain in faults[0], bad
    assert chip_smoke.attn_bwd_sass_faults(
        {k: v for k, v in good.items() if k != plain}) == ["missing (False, 1)"]


def test_the_attn_bwd_fault_reaches_the_dq_product_alone():
    """`--plant-fault attn_bwd` guards the dQ product (dS K, A from
    registers) with the key loop's index, so the last key block's products
    leave dQ and nothing else."""
    source, pattern, replacement, reaches = chip_smoke.FAULTS["attn_bwd"]
    text = open(os.path.join(REPO, "dense2sparse_vit_torch", "csrc", source)).read()
    assert text.count(pattern) == 1 and "dq[qq]" in pattern and reaches == "attn_bwd"
    assert replacement == pattern.replace("wgmma", "if (j + 1 < QB) wgmma")
    kernel = text[text.index("attention_bwd_kernel(const __grid_constant__"):]
    assert pattern in kernel[:kernel.index("\n}\n")]


HD_FWD = "_ZN3d2s19attention_hd_kernelILi96ELb0EEEvPK13__nv_bfloat16xiiPS1_PfS4_PKfiiffii"
HD_BWD = ("_ZN3d2s23attention_hd_bwd_kernelILi16ELb1EEEvPK13__nv_bfloat16xiiS3_S3_PK6float4PKfS8_"
          "PS1_PfSA_iiffii")


def test_hd_kind_reads_the_head_width_instantiations():
    """The build phase's reading of the head-width cores' names (as ptxas
    printed them on the card): (padded width, policy mode), each core's
    spill lines apart from the other's."""
    assert chip_smoke.hd_kind(HD_FWD, "attention_hd_kernel") == (96, False)
    assert chip_smoke.hd_kind(HD_BWD, "attention_hd_bwd_kernel") == (16, True)
    assert chip_smoke.hd_kind(HD_BWD, "attention_hd_kernel") is None
    assert chip_smoke.hd_kind(ATTN_BWD_PLAIN, "attention_hd_bwd_kernel") is None
    assert len(set(chip_smoke.HD_KINDS)) == 16
    log = "\n".join(f"ptxas info    : Function properties for {n}\n"
                    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                    for n in (HD_FWD, HD_BWD, ATTN_BWD_PLAIN))
    assert list(chip_smoke.gemm_spills(log, "attention_hd_kernel")) == [HD_FWD]
    assert list(chip_smoke.gemm_spills(log, "attention_hd_bwd_kernel")) == [HD_BWD]


@pytest.mark.parametrize("kind,kernel,guarded", [
    ("head_width", "attention_hd_kernel(const bf16*", "(o, pa[kk], "),
    ("head_width_bwd", "attention_hd_bwd_kernel(const bf16*", "da[jq >> 1]")])
def test_the_head_width_faults_sit_in_their_kernels(kind, kernel, guarded):
    """`--plant-fault head_width` guards the forward's P V product (O from P
    in registers) with the key loop's index, `head_width_bwd` zeroes the
    last key block's dS in the stage that dQ alone reads; each pattern lies
    in its kernel's body."""
    source, pattern, replacement, _ = chip_smoke.FAULTS[kind]
    text = open(os.path.join(REPO, "dense2sparse_vit_torch", "csrc", source)).read()
    assert text.count(pattern) == 1 and guarded in pattern and replacement != pattern
    body = text[text.index(kernel):]
    assert pattern in body[:body.index("\n}\n")]


@pytest.mark.parametrize("name,backwards", [
    ("PER_TRAIN_STEP", 12), ("PER_POLICY_TRAIN_STEP", 12), ("PER_ATTN_TRAIN_STEP", 12),
    ("PER_T2T_TRAIN_STEP", 14), ("PER_T2T_DENSE_STEP", 14), ("PER_ATTN_BLOCK_TRAINABLE", 2),
    ("PER_FORWARD", 0), ("PER_EVAL_STEP", 0)])
def test_core_launches_follow_every_backward_with_attention(name, backwards):
    """The attention core backward runs once inside every whole-block,
    packed-attention and attention half-block backward, and nowhere else."""
    per = getattr(chip_smoke, name)
    for counts in (per.values() if name == "PER_EVAL_STEP" else [per]):
        with_attention = sum(v for k, v in counts.items() if "backward" in k
                             and not k.startswith("fused_mlp"))
        assert counts["attention_bwd"] == backwards == with_attention


def test_wgmma_notices_count_injected_fences_and_catch_serialization():
    """The build phase's reading of ptxas's C75xx notices: C7519's injected
    fences counted per instantiation, a serialization notice kept (the
    build fails on it), another kernel's notices left out."""
    arrive = ("ptxas info    : (C7519) warpgroup.arrive is injected in around line {} by "
              "compiler to allow use of registers in GMMA in function '{}'")
    serial = ("ptxas info    : (C7510) Potential Performance Loss: wgmma.mma_async "
              f"instructions are serialized due to the presence of Extern calls in the "
              f"function '{ATTN_BWD_POLICY}'")
    log = "\n".join([arrive.format(5902, ATTN_BWD_PLAIN), arrive.format(6012, ATTN_BWD_PLAIN),
                     serial, arrive.format(7000, BF16_NK),
                     f"ptxas info    : Function properties for {ATTN_BWD_PLAIN}"])
    assert chip_smoke.wgmma_notices(log) == {
        ATTN_BWD_PLAIN: {"injected_arrive": 2, "serialized": []},
        ATTN_BWD_POLICY: {"injected_arrive": 0, "serialized": [serial]}}
    assert chip_smoke.wgmma_notices(log, "11gemm_kernel") == {
        BF16_NK: {"injected_arrive": 1, "serialized": []}}


def _predictor_case(small):
    """A bf16 predictor (seeded, as `checkout_ab.seeded_predictor` draws
    them) and its strided spatial input."""
    from dense2sparse_vit_torch.scripts.checkout_ab import seeded_predictor

    x = torch.randn((4, 14, 64), generator=torch.Generator().manual_seed(31)).to(torch.bfloat16)
    w = seeded_predictor(64, small, 31, torch.device("cpu")).kernel_weights(torch.bfloat16)
    return x[:, 1:], w


@pytest.mark.parametrize("small", [True, False])
def test_check_predictor_passes_the_plain_versions(capsys, small):
    xs, w = _predictor_case(small)
    with torch.inference_mode():
        scores, err = chip_smoke.check_predictor(torch, xs, w, "case", "predictor")
    line = _last_line(capsys)
    assert line["bit_equal"] and line["max_abs_err"] == 0.0
    assert line["split_max_abs_err"] <= chip_smoke.STAGE_TOL * line["max_abs_ref"]
    assert scores.shape == xs.shape[:2] and err == line["split_max_abs_err"]


@pytest.mark.parametrize("fault", ["next_sample_pool", "launches_differ"])
def test_check_predictor_rejects_a_wrong_pool_and_unequal_launches(monkeypatch, fault):
    """Phase 3's and 31's predictor check rejects the planted fault's effect
    (each sample's pooled half taken from the next sample, simulated on the
    plain split form) and two launches whose scores differ."""
    from dense2sparse_vit_torch.ops.predictor import predictor_lg_split_reference

    xs, w = _predictor_case(True)
    calls = []

    def faulty(x, weights, eps=1e-5):
        calls.append(1)
        if fault == "launches_differ":
            out = predictor_lg_split_reference(x, weights, eps)
            return out if len(calls) == 1 else out + 2 ** -6 * out.abs().max()
        mean = torch.Tensor.mean

        def next_sample(t, *args, **kwargs):
            out = mean(t, *args, **kwargs)
            return out.roll(-1, 0) if kwargs.get("dim") == 1 else out

        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "mean", next_sample)
            return predictor_lg_split_reference(x, weights, eps)

    monkeypatch.setattr(ops, "fused_predictor_lg", faulty)
    with torch.inference_mode(), pytest.raises(AssertionError,
                                               match=chip_smoke.FAULTS["predictor"][3]):
        chip_smoke.check_predictor(torch, xs, w, "case", "predictor")


# ---- phase 32: the training entry point ----------------------------------------


def test_the_cached_step_table_has_no_teacher_block():
    """A cached step launches PER_TRAIN_STEP less the teacher's 12 CLS-row
    blocks; check_step_launches holds every step to its table and rejects a
    cached run whose steps ran the teacher, or no step at all."""
    cached, live = chip_smoke.PER_CACHED_TRAIN_STEP, chip_smoke.PER_TRAIN_STEP
    assert cached["fused_transformer_block_cls"] == 0 and live["fused_transformer_block_cls"] == 12
    assert {k: v for k, v in cached.items() if k != "fused_transformer_block_cls"} == {
        k: v for k, v in live.items() if k != "fused_transformer_block_cls"}
    chip_smoke.check_step_launches([dict(cached)] * 8, cached, "cached")
    with pytest.raises(AssertionError, match="steps \\[3\\]"):
        chip_smoke.check_step_launches([dict(cached)] * 3 + [dict(live)], cached, "cached")
    with pytest.raises(AssertionError, match="0 steps"):
        chip_smoke.check_step_launches([], cached, "cached")


def _resume_state(seed=0):
    """A checkpoint of a tiny student after one AdamW update."""
    from dense2sparse_vit_torch.core import TrainConfig
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import make_optimizer

    model = create_model("dynamic_vit_tiny_patch16_224_student", device="cpu",
                         generator=torch.Generator().manual_seed(seed), img_size=32,
                         patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10,
                         pruning_locs=(1,), keep_ratios=(0.5,))
    opt = make_optimizer(model, TrainConfig(), 3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    return {"student": model.state_dict(), "optimizer": opt.state_dict(), "step": 1}


@pytest.mark.parametrize("plant", ["parameter", "moment", "count", "step", "best"])
def test_check_resume_rejects_a_one_ulp_difference(plant):
    """The resume comparison passes two equal checkpoints and rejects one
    ulp in one parameter element or one Adam moment element, an update or
    step count off by one, or a different best metric."""
    import copy

    a = _resume_state()
    res = chip_smoke.check_resume(torch, a, copy.deepcopy(a), (0.25, 0.25))
    assert res["student"]["bit_equal"] and res["moments"]["bit_equal"]
    b, best = copy.deepcopy(a), (0.25, 0.25)
    if plant == "parameter":
        w = b["student"]["head.weight"]
        w.view(-1)[5] = torch.nextafter(w.view(-1)[5], torch.tensor(float("inf")))
    elif plant == "moment":
        m = b["optimizer"]["state"][0]["exp_avg"]
        m.view(-1)[0] = torch.nextafter(m.view(-1)[0], torch.tensor(-float("inf")))
    elif plant == "count":
        b["optimizer"]["schedule"]["count"] += 1
    elif plant == "step":
        b["step"] += 1
    else:
        best = (0.25, 0.26)
    with pytest.raises(AssertionError, match="resumed run differs"):
        chip_smoke.check_resume(torch, a, b, best)


def test_check_loop_metrics_rejects_a_non_finite_record():
    good = [{"step": 0, "time": 1.0, "train/loss": 2.5}, {"step": 1, "val/val_acc": 0.1}]
    chip_smoke.check_loop_metrics(good, "run")
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_loop_metrics(good + [{"step": 2, "train/loss": float("nan")}], "run")
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.check_loop_metrics([], "run")


def test_loop_spy_counts_steps_and_preempts(tmp_path):
    """On a tiny CPU run of the loop: the spy sees every train and eval step
    (launches 0 for CPU tensors), whether each micro-step moved the
    parameters, and raises Preempted in place of the step after
    `stop_after`, leaving the checkpoints of the epochs before it."""
    from dense2sparse_vit_torch import cli
    from dense2sparse_vit_torch.train.loop import run_experiment
    from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager

    root = str(tmp_path / "img")
    n = chip_smoke.write_image_folder(root, classes=2, images=10, sides=(32, 40))
    assert n == 20
    argv = ["--imgnet-val-dir", root, "--img-size", "32", "--eval-crop", "32",
            "--eval-resize", "36", "--patch-size", "8", "--num-classes", "10", "--arch",
            "deit_tiny", "--pruning-locs", "1", "--keep-ratios", "0.5", "--batch-size", "4",
            "--epochs", "3", "--grad-accum-steps", "2"]
    cfg, _ = cli.parse_config(argv)
    with chip_smoke.LoopSpy(torch, track=True, stop_after=8) as spy:
        with pytest.raises(chip_smoke.Preempted):
            run_experiment(cfg, str(tmp_path / "run"), device="cpu")
    assert len(spy.steps) == 8 and spy.moved == [False, True] * 4
    assert all(d == chip_smoke.NO_LAUNCHES for d in spy.steps + spy.evals)
    assert spy.valid == [4, 4]  # 2 epochs of one eval batch of the 4 val images
    assert CheckpointManager(str(tmp_path / "run" / "ckpt")).latest_step() == 8
    from dense2sparse_vit_torch.train import loop
    assert loop.make_train_step.__name__ == "make_train_step"  # the spy put it back


# ---- phase 33: the student's other modes -------------------------------------


def test_the_mode_tables_cover_every_mode():
    """Every mode has its train and eval launch tables over every kernel;
    dropout's step leaves the whole block for the packed core, soft top-k's
    gathers nothing, remat runs the forward twice."""
    specs = chip_smoke.mode_specs()
    assert set(specs) == {"soft_topk", "random", "cls_from_teacher", "predictor_bn",
                          "early_exit", "dropout", "remat", "attn_block0"}
    assert set(specs) == set(chip_smoke.PER_MODE_TRAIN_STEP) == set(chip_smoke.PER_MODE_EVAL_STEP)
    for table in (*chip_smoke.PER_MODE_TRAIN_STEP.values(),
                  *chip_smoke.PER_MODE_EVAL_STEP.values()):
        assert set(table) == set(chip_smoke.KERNEL_NAMES)
    steps = chip_smoke.PER_MODE_TRAIN_STEP
    assert steps["dropout"]["fused_transformer_block"] == 0
    assert steps["dropout"]["fused_attention_packed"] == 12
    assert steps["soft_topk"]["fused_gather_tokens"] == 0
    assert (steps["remat"]["fused_transformer_block"]
            + steps["remat"]["fused_transformer_block[scaled]"]) == 24
    assert specs["soft_topk"][1]["topk_num_samples"] == 500 and specs["soft_topk"][2] == 0


def test_check_mode_launches_rejects_a_mode_that_ran_a_plain_version():
    want = chip_smoke.PER_MODE_TRAIN_STEP["dropout"]
    chip_smoke.check_mode_launches(dict(want), want, "dropout")
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_mode_launches({**want, "fused_attention_packed": 0,
                                        "fused_attention_backward_packed": 0}, want, "dropout")


def _soft_inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.rand((2, 20), generator=g), torch.randn((2, 30, 20), generator=g),
            torch.randn((2, 7, 20), generator=g))


def test_check_soft_topk_backward_passes_the_port_and_rejects_a_wrong_gradient(monkeypatch,
                                                                               capsys):
    from dense2sparse_vit_torch.ops.perturbed_topk import PerturbedTopK

    x, z, g = _soft_inputs()
    assert chip_smoke.check_soft_topk_backward(torch, x, z, 0.05, 7, g) <= 1e-6
    real = PerturbedTopK.backward

    def off(ctx, grad):  # the estimator's 1 / (nS sigma) off by one part in 10^4
        dx, *rest = real(ctx, grad)
        return (dx * (1 + 1e-4), *rest)

    monkeypatch.setattr(PerturbedTopK, "backward", staticmethod(off))
    with pytest.raises(AssertionError, match="soft_topk_backward"):
        chip_smoke.check_soft_topk_backward(torch, x, z, 0.05, 7, g)


def _remat_grads(remat):
    """One CPU step of a small soft top-k student at drop path 0.2, with or
    without remat, from the same weights and draws."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=1, num_classes=10,
              pruning_locs=(1, 2), keep_ratios=(0.7, 0.49), small_predictor=True,
              differentiable_topk=True, topk_num_samples=16, drop_path_rate=0.2)
    student = create_model("dynamic_vit_tiny_patch16_224_student", device="cpu", remat=remat,
                           **kw)
    teacher = create_model("dynamic_vit_tiny_patch16_224_teacher", device="cpu",
                           **{k: kw[k] for k in ("img_size", "patch_size", "embed_dim",
                                                 "depth", "num_heads", "num_classes")})
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(epochs=10, warmup_epochs=5))
    opt = make_optimizer(student, cfg.train, 3)
    opt.count = 18
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    make_train_step(student, teacher, opt, cfg)(x, torch.tensor([1, 2]), 6,
                                                generator=torch.Generator().manual_seed(11))
    return chip_smoke.train_step_grads(torch, student)


def test_check_remat_passes_remat_and_rejects_a_recompute_that_draws_anew(monkeypatch,
                                                                          capsys):
    plain = _remat_grads(False)
    assert chip_smoke.check_remat(torch, _remat_grads(True), plain)["bit_equal"]
    obj, attr, fault, mode = chip_smoke.mode_fault("remat")
    assert mode == "remat"
    monkeypatch.setattr(obj, attr, fault)
    with pytest.raises(AssertionError, match="remat gradients"):
        chip_smoke.check_remat(torch, _remat_grads(True), plain)


def test_check_bn_eval_passes_running_stats_and_rejects_batch_statistics(monkeypatch,
                                                                        capsys):
    from dense2sparse_vit_torch.models import create_model

    student = create_model("dynamic_vit_tiny_patch16_224_student", device="cpu", img_size=32,
                           patch_size=8, embed_dim=64, depth=2, num_heads=1, num_classes=10,
                           pruning_locs=(1,), keep_ratios=(0.5,), predictor_bn=True)
    images = torch.randn((8, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    assert chip_smoke.check_bn_eval(torch, student, images) <= 1e-6
    obj, attr, fault, mode = chip_smoke.mode_fault("bn_eval")
    assert mode == "predictor_bn"
    monkeypatch.setattr(obj, attr, fault)
    with pytest.raises(AssertionError, match="bn_eval"):
        chip_smoke.check_bn_eval(torch, student, images)


def test_the_mode_plain_fault_takes_the_dropout_students_plain_core(monkeypatch):
    """The fault swaps the packed core's wrapper for plain attention: the
    dropout student's fused train step no longer reaches the wrapper."""
    import dense2sparse_vit_torch.nn.layers as layers
    from dense2sparse_vit_torch.models import create_model

    calls = []
    real = layers.fused_attention_packed_trainable
    monkeypatch.setattr(layers, "fused_attention_packed_trainable",
                        lambda *a: calls.append(1) or real(*a))
    student = create_model("dynamic_vit_tiny_patch16_224_student", device="cpu", img_size=32,
                           patch_size=8, embed_dim=64, depth=2, num_heads=1, num_classes=10,
                           pruning_locs=(1,), keep_ratios=(0.5,), drop_rate=0.1,
                           use_fused_attention=True).train()
    x = torch.randn((2, 32, 32, 3))
    with pytest.warns(UserWarning, match="dropout"):
        student(x, collect_cls_attns=False, generator=torch.Generator())
    assert len(calls) == 2
    obj, attr, fault, mode = chip_smoke.mode_fault("mode_plain")
    assert mode == "dropout"
    monkeypatch.setattr(obj, attr, fault)
    calls.clear()
    student(x, collect_cls_attns=False, generator=torch.Generator())
    assert not calls


# ---- phase 34: the DeiT, ViT and DINO families; 384-px training ---------------


def test_the_384_tables_cover_every_kernel_and_the_long_path():
    """Each 384-px mode's step table covers every kernel; the long-path
    launches are the blocks before the second stage (576 patches: 577 and
    404 tokens) in top-k and attn, every block in threshold mode."""
    from dense2sparse_vit_torch.core import PruningConfig

    for _, table, _ in chip_smoke.MODES_384.values():
        assert set(table) == set(chip_smoke.KERNEL_NAMES)
    keep = PruningConfig(pruning_locs=(3, 6, 9), keep_ratios=(0.7, 0.49, 0.343)).keep_counts(576)
    tokens = [577] * 3 + [keep[0] + 1] * 3 + [keep[1] + 1] * 3 + [keep[2] + 1] * 3
    long = sum(n > 384 for n in tokens)
    assert tokens[3] == 404 and tokens[6] == 283 and tokens[9] == 198
    assert chip_smoke.MODES_384["topk"][2] == chip_smoke.MODES_384["attn"][2] == long == 6
    assert chip_smoke.MODES_384["threshold"][2] == 12
    assert {n for n, _ in chip_smoke.FAMILY_MODELS} >= set(chip_smoke.FAMILY_TIMED)


def test_the_kernels_line_holds_the_sub_rows_with_every_key():
    tally = chip_smoke.Tally()
    tally.rows["attention_bwd[long]"]["launches"] += 6
    tally.add("attention_bwd[long]", 3, 0.5, 10.0, {"ops_ms": 0.2, "bytes_ms": 0.1}, 0.4)
    rows = {r["name"]: r for r in tally.line()["kernels"]}
    assert set(rows) == set(chip_smoke.KERNEL_NAMES) | set(chip_smoke.SUB_ROWS)
    r = rows["attention_bwd[long]"]
    assert r["launches"] == 6 and r["ms"] == 1.5 and r["bound_by"] == "operations"
    assert abs(r["library_ms"] - 1.2) < 1e-12 and r["replaces"].endswith("block.py:729")
    assert all(set(x) == set(r) for x in rows.values())


def test_plain_twin_runs_every_plain_version_on_the_same_weights():
    """The twin of a fused DINO student has the same state and no fused
    flag left; on the CPU its eval forward equals the fused model's."""
    from dense2sparse_vit_torch.models import create_model

    model = create_model("dino_small_predictor", device="cpu", img_size=32, patch_size=8,
                         embed_dim=128, num_heads=2, depth=2, use_fused_attention=True).eval()
    twin = chip_smoke.plain_twin(model)
    assert not twin.cfg.use_fused_attention and model.cfg.use_fused_attention
    assert not any(getattr(m, "use_fused", False) for m in twin.modules())
    for (k, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), k
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = chip_smoke.output_leaves(chip_smoke.family_forward(torch, model,
                                                               "dino_small_predictor", x))
        b = chip_smoke.output_leaves(chip_smoke.family_forward(torch, twin,
                                                               "dino_small_predictor", x))
    assert len(a) == len(b) == 1 and torch.equal(a[0], b[0])
    want = chip_smoke.family_launches(model, "dino_small_predictor")
    assert want["fused_transformer_block"] == 2 and want["fused_gather_tokens"] == 1


def test_replay_hands_the_plain_run_the_recorded_decisions():
    """A masked DeiT's Gumbel decisions recorded in one run come back, in
    order, in the next, whatever the second run's generator draws."""
    import dense2sparse_vit_torch.models.deit as deit_mod
    from dense2sparse_vit_torch.models import create_model

    model = create_model("deit_small_patch16_224_predictor", device="cpu", img_size=32,
                         patch_size=8, embed_dim=128, num_heads=2, depth=3).eval()
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), chip_smoke.Replay(deit_mod, "gumbel_softmax") as rec:
        first = model(x, generator=torch.Generator().manual_seed(5))
    assert len(rec.out) == 1 and deit_mod.gumbel_softmax is not rec.out
    with torch.no_grad(), chip_smoke.Replay(deit_mod, "gumbel_softmax", rec):
        again = model(x, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        fresh = model(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(first[2], again[2]) and torch.equal(first[0], again[0])
    assert not torch.equal(first[2], fresh[2])


def test_mode_recorder_replays_threshold_masks():
    """The threshold mode's keep masks recorded in one step's forward come
    back in the plain step's, so that both keep the same tokens."""
    from dense2sparse_vit_torch.models import create_model

    model = create_model("dynamic_vit_small_patch16_224_student", device="cpu", img_size=32,
                         patch_size=8, embed_dim=128, num_heads=2, depth=4,
                         pruning_locs=(1, 2), keep_ratios=(0.7, 0.5),
                         patch_score_threshold=0.5).eval()
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), chip_smoke.ModeRecorder() as rec:
        first = model(x, collect_cls_attns=False)
    assert len(rec.masks) == 2 and not rec.kept
    x2 = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), chip_smoke.ModeRecorder(replay_from=rec):
        replayed = model(x2, collect_cls_attns=False)
    assert torch.equal(replayed.keep_mask, first.keep_mask)


# ---- phase 37: the experiment drivers ----------------------------------------


def test_the_experiment_tables_count_each_paths_kernels():
    """(a) 24 blocks, 3 predictors, 3 gathers a batch; (b) 11 blocks and the
    CLS-row block a forward; (c) 12 blocks and 12 - mask_block block
    backwards an epoch (with their inner kernels), the teacher's 12 once."""
    nonzero = lambda t: {k: v for k, v in t.items() if v}  # noqa: E731
    assert nonzero(chip_smoke.PER_EVAL_BATCH) == {
        "fused_transformer_block": 24, "fused_predictor_lg": 3, "fused_gather_tokens": 3}
    assert nonzero(chip_smoke.PER_PATCH_DROP) == {
        "fused_transformer_block": 11, "fused_transformer_block_cls": 1}
    assert nonzero(chip_smoke.PER_MASK_EPOCH) == {
        "fused_transformer_block": 12, "fused_transformer_block_backward": 5, "ln_bwd": 10,
        "column_sums": 5, "attention_bwd": 5}
    run = chip_smoke.scaled(chip_smoke.PER_MASK_EPOCH, 5, chip_smoke.PER_TEACHER)
    assert run["fused_transformer_block"] == 72 and run["fused_transformer_block_backward"] == 25
    assert set(run) == set(chip_smoke.KERNEL_NAMES)


def test_check_eval_agreement_takes_one_percent_of_the_images():
    plain = {"images": 720, "pruned_top1": 0.5, "unpruned_top1": 0.6}
    near = {"images": 720, "pruned_top1": 0.5 + 7 / 720, "unpruned_top1": 0.6 - 7 / 720}
    assert chip_smoke.check_eval_agreement(near, plain, 720)["pruned"] == pytest.approx(7)
    for bad in ({**near, "pruned_top1": 0.5 + 8 / 720}, {**near, "images": 640}):
        with pytest.raises(AssertionError, match="eval_imagenet"):
            chip_smoke.check_eval_agreement(bad, plain, 720)


def _bf16(torch, x):
    return torch.from_numpy(x.astype("float32")).bfloat16().float().numpy()


def test_keep_agreement_explains_flips_by_the_rows_error():
    """Near-uniform attention, as random weights give (16 rows, the mean
    over 6 heads of the softmax of logits of std 0.15): rows with another
    bf16-sized error than the plain model's agree with the exact masks as
    well as the plain model's rows do, though both flip patches at the cut;
    rows off by 3 x STAGE_TOL of their largest entry, or missing one head,
    agree less, and fail."""
    import numpy as np

    rng = np.random.default_rng(0)
    logits = rng.normal(0, 0.15, (16, 6, 196))
    heads = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    exact = heads.mean(1)
    plain = _bf16(torch, exact)
    kernel = _bf16(torch, exact * (1 + rng.normal(0, 2.0 ** -9, exact.shape)))
    assert chip_smoke.keep_agreement(exact, exact, exact) == {
        "kernel_vs_plain": 1.0, "kernel_vs_fp32": 1.0, "plain_vs_fp32": 1.0}
    shares = chip_smoke.keep_agreement(kernel, plain, exact)
    assert shares["plain_vs_fp32"] < 1.0 and shares["kernel_vs_plain"] < 1.0
    assert chip_smoke.masks_agree(shares)
    off = exact + rng.uniform(-1, 1, exact.shape) * 3 * chip_smoke.STAGE_TOL * exact.max(
        -1, keepdims=True)
    one_head_less = heads[:, 1:].mean(1)
    for fault in (off, one_head_less):
        assert not chip_smoke.masks_agree(chip_smoke.keep_agreement(_bf16(torch, fault), plain,
                                                                    exact))


def test_weight_grad_spy_counts_what_the_block_backward_returns():
    """On the CPU the trainable block runs its plain versions: with frozen
    weights one backward returns no weight gradient, with trainable ones
    a gradient for each weight; the spy leaves the class as it was."""
    from dense2sparse_vit_torch.ops import block

    C, H = 64, 2
    g = torch.Generator().manual_seed(0)
    w = {k: None for k in block.BLOCK_WEIGHT_KEYS}
    shapes = {"ln1_w": (C,), "ln1_b": (C,), "wqkv": (3 * C, C), "bqkv": (3 * C,),
              "wproj": (C, C), "bproj": (C,), "ln2_w": (C,), "ln2_b": (C,),
              "w1": (4 * C, C), "b1": (4 * C,), "w2": (C, 4 * C), "b2": (C,)}
    saved = block._TrainableBlock.__dict__["backward"]
    for trainable in (False, True):
        for k in block.BLOCK_WEIGHT_KEYS:
            w[k] = (torch.randn(shapes[k], generator=g) * 0.05).requires_grad_(trainable)
        x = torch.randn(2, 5, C, generator=g, requires_grad=True)
        with chip_smoke.WeightGradSpy() as spy:
            block.fused_transformer_block_trainable(x, w, H).sum().backward()
        assert spy.calls == 1
        assert spy.weight_grads == (len(block.BLOCK_WEIGHT_KEYS) if trainable else 0)
        assert x.grad is not None
    assert block._TrainableBlock.__dict__["backward"] is saved


def test_check_mask_history_holds_epoch_zero_and_the_logits():
    h = [{"kd_kl": 1.0, "kd_ce": 6.9, "kd_ratio_penalty": 0.1, "acc": 0.0}]
    assert chip_smoke.check_mask_history(h, [dict(h[0], kd_ce=6.95)], 0.1) == pytest.approx(
        0.05 / 8.05)
    for kernel, moved in ((h, 0.0), ([dict(h[0], kd_ce=float("nan"))], 0.1),
                          ([dict(h[0], kd_ce=7.2)], 0.1)):
        with pytest.raises(AssertionError, match="optimized_mask"):
            chip_smoke.check_mask_history(kernel, h, moved)


def test_native_ulps_and_params_rel_diff():
    import numpy as np

    want = np.array([2.5, -1.0], np.float32)
    got = want + np.array([np.spacing(np.float32(2.5)), 0], np.float32)
    assert chip_smoke.native_ulps(got, want) == 1.0
    a = {"w": torch.tensor([1.0, 2.0]), "b": torch.tensor([0.5])}
    b = {"w": torch.tensor([1.0, 2.0 + 2e-5]), "b": torch.tensor([0.5])}
    want = (b["w"][1] - 2.0).item() / b["w"][1].item()
    assert chip_smoke.params_rel_diff(torch, a, b) == pytest.approx(want)
