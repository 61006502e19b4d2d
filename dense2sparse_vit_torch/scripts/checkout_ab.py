"""Measure one checkout of the port on the card, so that two can be compared.

    PYTHONPATH=CHECKOUT python ANY_CHECKOUT/dense2sparse_vit_torch/scripts/checkout_ab.py \\
        --bits a.json
    PYTHONPATH=CHECKOUT python ANY_CHECKOUT/dense2sparse_vit_torch/scripts/checkout_ab.py \\
        --int8-times
    PYTHONPATH=CHECKOUT python ANY_CHECKOUT/dense2sparse_vit_torch/scripts/checkout_ab.py \\
        --attn-bwd-times
    PYTHONPATH=CHECKOUT python ANY_CHECKOUT/dense2sparse_vit_torch/scripts/checkout_ab.py \\
        --predictor-times
    PYTHONPATH=CHECKOUT python ANY_CHECKOUT/dense2sparse_vit_torch/scripts/checkout_ab.py \\
        --hd-times
    python -m dense2sparse_vit_torch.scripts.checkout_ab --compare a.json b.json

Run by its path, the script imports whichever `dense2sparse_vit_torch` is
first on PYTHONPATH, so one copy of it measures any checkout whose entry
points it calls (`ops.fused_transformer_block_int8` with its stages,
`ops.gemm.ln_gemm` and `weight_grad`, `ops.fused_transformer_block` and its
backward, `ops.fused_attention_backward_packed`, `ops.fused_predictor_lg`,
`ops.fused_attention_packed`, `ops.fused_attention_variant`);
run both checkouts in one call. Every input is drawn on the CPU
from a fixed seed and then moved to the device, so two checkouts see the
same values.

`--bits` writes {"package": the imported package's path, "card": ...,
"digests": {case: SHA-256 of the output's bytes}} for the cases:

- int8/<B>x<N>x<C>/<stage>: the W8A8 block at B=256, C=384, N = 197, 138,
  97, 68, at B=16, C=768, N=197 and at B=4, C=1024, N=197 (hidden 4096,
  the longest row a warp quantizes): its four quantizations' codes q1-q4
  and the products' outputs qkv, mid (x + proj, fp32), act (GELU(fc1)) and
  out (mid + fc2);
- ln/<M>x<C>/<residual>/<tensor>: the LayerNorm backward alone
  (`ops.norm.ln_backward`) at every width its warp kernel lays out (C a
  multiple of 32 up to 768; the card tests' shapes), with no residual, a
  bf16 and an fp32 one: dx, its fp32 copy, d_ln_w and d_ln_b;
- gemm/<name>: the bf16 GEMM engine's products at `chip_smoke.py` phase
  28's shapes: the block forward's four at M = 50,432, the backward's four
  dX products and four weight gradients (with the bias sums) at M = 25,216;
- block/<stage>, block_bwd/<tensor>: the bf16 block forward's stages and
  its backward's dx and gradients at B=64, N=197, C=384, and (block<d>/,
  block<d>_bwd/) at head widths d = 12 (32 heads, C=384) and 96 (8 heads,
  C=768) at B=16, N=197;
- core/<d>/<N>/<mode>/<tensor>: the attention cores through the packed
  entries at B=8, head widths 64 (6 heads), 12 (32) and 96 (8), N = 197,
  577 and 785 (at width 64 also the long path of its backward), and at
  N = 197 and 577 every other padded width up to 128 (d = 2, 32, 48, 80,
  112, 128) and the odd widths and those past 128 (d = 13, 127, 160, 256;
  left out where the checkout refuses them): the output and CLS rows in
  plain and policy mode (eps 0.1), dqkv with the CLS rows' cotangent folded
  in, and in policy mode dPolicy;
- rows/<case>/<tensor>: token rows aligned and off the 16-byte rules at
  B=8, N=197 (`row_cases`: the gather and scatter at D = 384 and 381, the
  small predictor at D = 384, 381 and 1016, the block both ways at C = 381,
  the int8 block at C = 1016; each left out where the checkout refuses it);
- variants/<N>/v<k>/<stage>: the half-block's inference variants v1-v3
  (`ops.fused_attention_variant`) at `chip_smoke.py` phase 27's shapes,
  B=256, C=384, 6 heads, N = 197, 138, 97, 68: the stages qkv and attn,
  and out.

`--compare` prints one JSON line per case of the first file (equal, or
missing from the second) and a summary line, and exits 1 if any differs.
`--device cpu` runs `--bits` on the plain versions at B=2, N=13, C=128 (a
smoke run).

`--int8-times` prints, at the headline student's widths (B=256, C=384, 6
heads, N = 197, 138, 97, 68), one JSON line per width: the int8 block's ms
per call by CUDA events (median of 5 runs of 10 calls) and the bf16 block
kernel's on the same input; from torch.profiler over 10 calls, the device
ms per call of the block's row quantizations (kernels named `rowq`), its
four products (named `gemm_kernel`), its attention core (`attention`) and
the rest; and, the same way, the device ms of `torch._int_mm` (cuBLASLt:
int8 codes in, int32 out, no dequantization) on the four products'
shapes, or the reason the card's build refused it. Its last line names
the package, the card and its power limit.

`--attn-bwd-times` prints, at B=128, C=384, 6 heads, N = 197, 138, 97, 68,
one JSON line per case of `ops.fused_attention_backward_packed` (plain
mode at every width; at N=197 also policy mode with dPolicy at eps 1e-6,
on a keep mask of ~60%, and the CLS rows' cotangent folded in): its ms per
call by CUDA events (median of 5 runs of 10 calls) and, from
torch.profiler over 10 calls, the device ms per call of the attention
core's backward (kernels named `attention_bwd_kernel`, in any checkout),
of the forward core it recomputes first (`attention_kernel`), of
dPolicy's head sum (`sum_heads`) and the rest. Its last line names the
package, the card and its power limit.

`--predictor-times` prints, at B=256, D=384, N = 196, 137, 96 (the
headline student's three stages), one JSON line per width for the small
and the large PredictorLG (seeded, on the strided spatial view x[:, 1:]
as the model passes it): `ops.fused_predictor_lg`'s ms per call by CUDA
events (median of 5 runs of 10 calls) and replayed from a CUDA graph of 20
calls (without the host's launch cost) and, from torch.profiler over 10
calls, the device ms per call of the kernels it launches, by name:
`predictor_kernel` (the fused kernel), or `gemm_kernel`, `ln_stats`,
`pool_broadcast` and `final_score` (the chain of launches before it), the
rest and the total. Its last line names the package, the card and its
power limit.

`--hd-times` prints, at the head widths other than 64 that the zoo uses
(d = 12 with 32 heads, C = 384; d = 96 with 8 heads, C = 768) and at an
odd width and two past 128 (d = 127 with 8 heads, 160 with 4, 256 with 3;
left out where the checkout refuses them), N = 197 and 577, B=64 (seeded
qkv and cotangent, plain mode), one JSON line per case:
from torch.profiler over 10 calls, the device ms per call of the forward
core inside `ops.fused_attention_packed` (kernels named
`attention_hd_kernel`) and of the backward core inside
`ops.fused_attention_backward_packed` (`attention_hd_bwd_kernel`, with
`attention_hd_rows` where a checkout has that launch; the forward it
recomputes first apart, as `recompute_ms`: the forward core's launch at the
same shape, read in the backward's window, which keeps every launch where
the forward's own window has been seen to lose some), each call's device
total, and the entries' ms per call by CUDA events (median of 5 runs of 10
calls).
Its last line names the package, the card and its power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys

import torch

import dense2sparse_vit_torch
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.ops.gemm import ln_gemm, weight_grad
from dense2sparse_vit_torch.utils import card_name_and_power_limit

# the bf16 engine's products: (name, M, N, K, weight (K, N), options)
GEMM_CASES = (
    ("qkv", 50432, 1152, 384, False, ("ln", "bias")),
    ("proj", 50432, 384, 384, False, ("bias", "residual")),
    ("fc1", 50432, 1536, 384, False, ("ln", "bias", "gelu", "preact")),
    ("fc2", 50432, 384, 1536, False, ("bias", "residual")),
    ("dy", 25216, 1536, 384, True, ("gelu_in",)),
    ("dln2", 25216, 384, 1536, True, ("out_f32",)),
    ("do", 25216, 384, 384, True, ()),
    ("dln1", 25216, 384, 1152, True, ("out_f32",)),
)
WGRAD_CASES = (("dw2", 25216, 384, 1536), ("dw1", 25216, 1536, 384),
               ("dwproj", 25216, 384, 384), ("dwqkv", 25216, 1152, 384))


def digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def seeded_block(C: int, H: int, seed: int, device) -> Block:
    """A block drawn on the CPU: matrices N(0, 1/fan_in), LayerNorms 1 +-
    0.1, biases 0.1 N(0, 1)."""
    blk = Block(C, H, use_fused=True, quant="int8")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() == 2:
                p.copy_(r * p.shape[1] ** -0.5)
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return blk.to(device).eval()


def randn(gen, shape, device, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device, dtype)


def int8_cases(device, shapes) -> dict:
    out = {}
    for B, N, C, H in shapes:
        blk = seeded_block(C, H, seed=C, device=device)
        x = randn(torch.Generator().manual_seed(N + C), (B, N, C), device)
        with torch.inference_mode():
            y, st = ops.fused_transformer_block_int8(x, blk.int8_weights(torch.bfloat16), H,
                                                     stages=True)
        for key in ("q1", "q2", "q3", "q4", "qkv", "mid", "act"):
            out[f"int8/{B}x{N}x{C}/{key}"] = digest(st[key])
        out[f"int8/{B}x{N}x{C}/out"] = digest(y)
    return out


# (M, C) of the LayerNorm backward's cases: every layout of its warp kernel
LN_CASES = ((25216, 384), (1003, 768), (63, 192), (97, 128), (40, 320), (25216, 448),
            (130, 576), (33, 704), (17, 32), (200, 96), (129, 736), (8704, 640))


def ln_cases(device, cases) -> dict:
    out = {}
    for M, C in cases:
        gen = torch.Generator().manual_seed(M + C)
        x = randn(gen, (M, C), device, scale=2.0)
        dy = randn(gen, (M, C), device, torch.float32)
        ln_w = 1 + randn(gen, (C,), device, torch.float32, 0.1)
        stats = ops.norm.ln_stats(x, 1e-6)
        for res_name, res in (("none", None), ("bf16", randn(gen, (M, C), device)),
                              ("fp32", randn(gen, (M, C), device, torch.float32))):
            with torch.no_grad():
                got = ops.norm.ln_backward(dy, x, stats, ln_w, res, fp32_copy=True)
            for key, t in zip(("dx", "dx_f32", "d_ln_w", "d_ln_b"), got):
                out[f"ln/{M}x{C}/{res_name}/{key}"] = digest(t)
    return out


def gemm_cases(device, scale_rows: int) -> dict:
    out = {}
    gen = torch.Generator().manual_seed(28)
    f32 = torch.float32
    for name, M, N, K, kn, opts in GEMM_CASES:
        M //= scale_rows
        a = randn(gen, (M, K), device)
        w = randn(gen, (K, N) if kn else (N, K), device, scale=K ** -0.5)
        kw = {"out_f32": "out_f32" in opts, "preact": "preact" in opts}
        if "ln" in opts:
            kw["ln"] = (1 + randn(gen, (K,), device, f32, 0.1), randn(gen, (K,), device, f32, 0.1),
                        1e-6)
        if "bias" in opts:
            kw["bias"] = randn(gen, (N,), device, f32)
        if "gelu" in opts:
            kw["act"] = "gelu"
        for key in ("residual", "gelu_in"):
            if key in opts:
                kw[key] = randn(gen, (M, N), device)
        with torch.inference_mode():
            got = ln_gemm(a, w, w_kn=kn, **kw)
        for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
            out[f"gemm/{name}" + ("/preact" if i else "")] = digest(t)
    for name, M, I, J in WGRAD_CASES:
        M //= scale_rows
        p, q = randn(gen, (M, I), device), randn(gen, (M, J), device)
        with torch.inference_mode():
            dw, db = weight_grad(p, q, bias=True)
        out[f"gemm/{name}"], out[f"gemm/{name}/db"] = digest(dw), digest(db)
    return out


def block_cases(device, B, N, C, H) -> dict:
    blk = seeded_block(C, H, seed=7, device=device)
    gen = torch.Generator().manual_seed(64)
    x, g = randn(gen, (B, N, C), device), randn(gen, (B, N, C), device)
    w = blk.kernel_weights(torch.bfloat16)
    with torch.no_grad():
        y, st = ops.fused_transformer_block(x, w, H, stages=True)
        dx, grads, _ = ops.fused_transformer_block_backward(x, g, w, H)
    out = {f"block/{k}": digest(v) for k, v in st.items() if v is not None}
    out["block/out"] = digest(y)
    out["block_bwd/dx"] = digest(dx)
    out.update({f"block_bwd/{k}": digest(v) for k, v in grads.items() if v is not None})
    return out


def core_cases(device, B, cases, optional=()) -> dict:
    """The packed attention both ways at each (N, C, H) of `cases`, plain
    and policy mode, with the CLS rows and their cotangent; those of
    `optional` too, where the checkout takes their head width."""
    out = {}
    for N, C, H in (*cases, *optional):
        if (N, C, H) in optional and not _takes(C, H):
            continue
        gen = torch.Generator().manual_seed(N + C + H)
        qkv, g = randn(gen, (B, N, 3 * C), device), randn(gen, (B, N, C), device)
        gcls = randn(gen, (B, H, N), device, torch.float32, 0.01)
        pol = (torch.rand((B, N), generator=gen) < 0.6).float()
        pol[:, 0] = 1.0
        pol = pol.to(device)
        tag = f"core/{C // H}/{N}"
        with torch.no_grad():
            for mode, kw in (("plain", {}), ("policy", {"policy": pol, "eps": 0.1})):
                o, cls = ops.fused_attention_packed(qkv, H, return_cls=True, **kw)
                got = ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, **kw)
                dqkv, dpol = got if kw else (got, None)
                out.update({f"{tag}/{mode}/out": digest(o), f"{tag}/{mode}/cls": digest(cls),
                            f"{tag}/{mode}/dqkv": digest(dqkv)})
                if dpol is not None:
                    out[f"{tag}/{mode}/dpolicy"] = digest(dpol)
    return out


def row_cases(device, B, N) -> dict:
    """Token rows aligned and off the 16-byte rules, each left out where the
    checkout refuses it (ValueError): the gather and the scatter (bf16) at D
    = 384 and 381; the small predictor's scores at D = 384, 381 and 1016;
    the bf16 block both ways at C = 381 (three heads of 127) and the int8
    block's stages at C = 1016 (eight heads of 127)."""
    from dense2sparse_vit_torch.nn.predictor import PredictorLG

    out = {}

    def take(name, fn):
        try:
            with torch.no_grad():
                got = fn()
        except ValueError:
            return
        out.update({f"rows/{name}/{k}": v if isinstance(v, str) else digest(v)
                    for k, v in got.items() if v is not None})

    gen = torch.Generator().manual_seed(38)
    idx = torch.randint(-1, N + 1, (B, (N * 7) // 10), generator=gen).to(device)
    for D in (384, 381):
        x = randn(gen, (B, N, D), device)
        take(f"gather/{D}", lambda: {"out": ops.fused_gather_tokens(x, idx)})
        take(f"scatter/{D}", lambda: {
            "out": ops.fused_scatter_tokens(x[:, :idx.shape[1]].contiguous(), idx, N)})
    for D in (384, 381, 1016):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(D)
            pred = PredictorLG(D, small_predictor=True, use_fused=True)
        w = pred.to(device).eval().kernel_weights(torch.bfloat16)
        x = randn(gen, (B, N, D), device)
        take(f"pred/{D}", lambda: {"scores": ops.fused_predictor_lg(x[:, 1:], w)})
    take("block381", lambda: block_cases(device, B, N, 381, 3))
    blk = seeded_block(1016, 8, seed=1016, device=device)
    x = randn(gen, (B, N, 1016), device)

    def int8():
        y, st = ops.fused_transformer_block_int8(x, blk.int8_weights(torch.bfloat16), 8,
                                                 stages=True)
        return {**{k: st[k] for k in ("q1", "q2", "q3", "q4", "qkv", "mid", "act")}, "out": y}

    take("int8_1016", int8)
    return out


def variant_cases(device, B, ns, C, H) -> dict:
    """The half-block's inference variants v1-v3 (`ops.fused_attention_variant`)
    at B, C, H and each N of `ns`: the stages qkv and attn, and out."""
    blk = seeded_block(C, H, seed=27, device=device)
    w = blk.kernel_weights(torch.bfloat16)
    w6 = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")]
    out = {}
    for N in ns:
        x = randn(torch.Generator().manual_seed(N + 27), (B, N, C), device)
        for v in (1, 2, 3):
            with torch.inference_mode():
                y, st = ops.fused_attention_variant(v, x, *w6, H, stages=True)
            tag = f"variants/{N}/v{v}"
            out.update({f"{tag}/qkv": digest(st["qkv"]), f"{tag}/attn": digest(st["attn"]),
                        f"{tag}/out": digest(y)})
    return out


def _takes(C: int, H: int) -> bool:
    """Whether the checkout's kernels take head width C / H."""
    from dense2sparse_vit_torch.ops.block import head_width

    try:
        head_width(C, H, "checkout_ab")
    except ValueError:
        return False
    return True


def measure(device) -> dict:
    if device.type == "cpu":  # the plain versions, at a smoke size
        shapes, rows, blk = [(2, 13, 128, 2)], 2048, (2, 13, 128, 2)
        wide, cores, core_b = [(2, 13, 96, 8)], [(13, 128, 2), (13, 96, 8)], 2
        lns, new_cores = ((13, 128), (5, 96)), []
        variants = (2, (13,), 128, 2)
    else:
        shapes = [(256, n, 384, 6) for n in (197, 138, 97, 68)] + [(16, 197, 768, 12),
                                                                    (4, 197, 1024, 16)]
        rows, blk, lns = 1, (64, 197, 384, 6), LN_CASES
        wide = [(16, 197, 384, 32), (16, 197, 768, 8)]
        cores = [(n, C, H) for n in (197, 577, 785) for C, H in ((384, 6), (384, 32), (768, 8))]
        cores += [(n, C, H) for n in (197, 577) for C, H in ((384, 192), (384, 12), (384, 8),
                                                             (640, 8), (448, 4), (768, 6))]
        new_cores = [(n, C, H) for n in (197, 577) for C, H in ((104, 8), (1016, 8), (640, 4),
                                                                (768, 3))]
        core_b = 8
        variants = (256, (197, 138, 97, 68), 384, 6)
    digests = {**int8_cases(device, shapes), **gemm_cases(device, rows),
               **block_cases(device, *blk), **core_cases(device, core_b, cores, new_cores),
               **ln_cases(device, lns), **row_cases(device, core_b, 197 if rows == 1 else 13),
               **variant_cases(device, *variants)}
    for B, N, C, H in wide:
        digests.update({k.replace("block", f"block{C // H}", 1): v
                        for k, v in block_cases(device, B, N, C, H).items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"package": dense2sparse_vit_torch.__file__, "card": card, "digests": digests}


# --int8-times: the headline student's widths, and the device-kernel groups
WIDTHS = (197, 138, 97, 68)
GROUPS = ("rowq", "gemm_kernel", "attention")


def events_ms(fn, iters=10, repeats=5) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters=20) -> float:
    """Ms per call of `iters` calls captured in one CUDA graph and replayed
    (median of 5 replays), warmed up first on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return events_ms(graph.replay, iters=1) / iters


def device_ms(fn, iters=10, groups=GROUPS) -> dict:
    """Device ms per call of fn, by kernel-name group (`groups`, the first
    that a kernel's name holds, and "other")."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups + ("other",), 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        group = next((g for g in groups if g in e.key), "other")
        out[group] += e.self_device_time_total / 1e3 / iters
    out["total"] = sum(out.values())
    return out


def int8_times(device) -> None:
    B, C, H = 256, 384, 6
    # the block's four products: (N, K) of the weight
    products = ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C))
    blk = seeded_block(C, H, seed=0, device=device)
    qw, w = blk.int8_weights(torch.bfloat16), blk.kernel_weights(torch.bfloat16)
    gen = torch.Generator().manual_seed(12)
    with torch.inference_mode():
        for n in WIDTHS:
            x = torch.randn((B, n, C), generator=gen).to(device, torch.bfloat16)
            int8 = lambda: ops.fused_transformer_block_int8(x, qw, H)  # noqa: E731
            row = {"N": n, "B": B, "C": C,
                   "int8_ms": events_ms(int8),
                   "bf16_ms": events_ms(lambda: ops.fused_transformer_block(x, w, H)),
                   "int8_device_ms": device_ms(int8)}
            codes = torch.randint(-127, 128, (B * n, 4 * C), generator=gen,
                                  dtype=torch.int8).to(device)
            mats = [torch.randint(-127, 128, (nn, k), generator=gen, dtype=torch.int8).to(device)
                    for nn, k in products]
            a = [codes[:, :k].contiguous() for _, k in products]

            def int_mm():
                for ai, wi in zip(a, mats):
                    torch._int_mm(ai, wi.t())

            try:
                row["int_mm_device_ms"] = device_ms(int_mm)["total"]
            except RuntimeError as e:  # the card's build may refuse a shape
                row["int_mm_refused"] = str(e)[:300]
            print(json.dumps(row), flush=True)
    print(json.dumps({"package": dense2sparse_vit_torch.__file__,
                      "card": card_name_and_power_limit()}), flush=True)


# --attn-bwd-times: the packed backward's device kernels
ATTN_BWD_GROUPS = ("attention_bwd_kernel", "reduce_kv", "attention_kernel", "sum_heads")


def attn_bwd_times(device) -> None:
    B, C, H = 128, 384, 6
    gen = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for n in WIDTHS:
            qkv = randn(gen, (B, n, 3 * C), device)
            g = randn(gen, (B, n, C), device)
            cases = [("plain", {})]
            if n == WIDTHS[0]:
                pol = (torch.rand((B, n), generator=gen) < 0.6).float().to(device)
                pol[:, 0] = 1.0
                gcls = (torch.randn((B, H, n), generator=gen) * 0.01).to(device)
                cases += [("policy", {"policy": pol, "eps": 1e-6}), ("gcls", {"gcls": gcls})]
            for mode, kw in cases:
                fn = lambda: ops.fused_attention_backward_packed(qkv, g, H, **kw)  # noqa: E731
                print(json.dumps({"N": n, "B": B, "C": C, "mode": mode, "ms": events_ms(fn),
                                  "device_ms": device_ms(fn, groups=ATTN_BWD_GROUPS)}),
                      flush=True)
    print(json.dumps({"package": dense2sparse_vit_torch.__file__,
                      "card": card_name_and_power_limit()}), flush=True)


# --predictor-times: the kernels fused_predictor_lg launches, in either design
PREDICTOR_GROUPS = ("predictor_kernel", "gemm_kernel", "ln_stats", "pool_broadcast",
                    "final_score")


def seeded_predictor(D: int, small: bool, seed: int, device):
    """A PredictorLG drawn on the CPU: matrices N(0, 1/fan_in), LayerNorm
    scales 1 +- 0.1, biases 0.1 N(0, 1)."""
    from dense2sparse_vit_torch.nn.predictor import PredictorLG

    pred = PredictorLG(D, small_predictor=small)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pred.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() == 2:
                p.copy_(r * p.shape[1] ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.1 * r)
            else:
                p.copy_(0.1 * r)
    return pred.to(device).eval()


def predictor_times(device) -> None:
    B, D = 256, 384
    gen = torch.Generator().manual_seed(15)
    xs = {n: randn(gen, (B, n + 1, D), device)[:, 1:] for n in (196, 137, 96)}
    with torch.inference_mode():
        for small in (True, False):
            w = seeded_predictor(D, small, 15 + small, device).kernel_weights(torch.bfloat16)
            for n, x in xs.items():
                fn = lambda: ops.fused_predictor_lg(x, w)  # noqa: E731
                print(json.dumps({"N": n, "B": B, "D": D, "small": small, "ms": events_ms(fn),
                                  "graph_ms": graph_ms(fn),
                                  "device_ms": device_ms(fn, groups=PREDICTOR_GROUPS)}),
                      flush=True)
    print(json.dumps({"package": dense2sparse_vit_torch.__file__,
                      "card": card_name_and_power_limit()}), flush=True)


# --hd-times: (d, heads, C) of the zoo's head widths other than 64, the
# sequences, the batch, and the device-kernel groups of either design
HD_WIDTHS = ((12, 32, 384), (96, 8, 768), (127, 8, 1016), (160, 4, 640), (256, 3, 768))
HD_TIMED = (197, 577)
HD_BATCH = 64
HD_GROUPS = ("attention_hd_kernel", "attention_hd_bwd_kernel", "attention_hd_rows", "sum_heads")


def hd_times(device) -> None:
    gen = torch.Generator().manual_seed(20)
    with torch.no_grad():
        for d, H, C in HD_WIDTHS:
            if not _takes(C, H):
                continue
            for n in HD_TIMED:
                qkv = randn(gen, (HD_BATCH, n, 3 * C), device)
                g = randn(gen, (HD_BATCH, n, C), device)
                fwd = lambda: ops.fused_attention_packed(qkv, H)  # noqa: E731
                bwd = lambda: ops.fused_attention_backward_packed(qkv, g, H)  # noqa: E731
                f_dev = device_ms(fwd, groups=HD_GROUPS)
                b_dev = device_ms(bwd, groups=HD_GROUPS)
                print(json.dumps({
                    "d": d, "heads": H, "N": n, "B": HD_BATCH,
                    "forward_ms": f_dev["attention_hd_kernel"],
                    "backward_ms": b_dev["attention_hd_bwd_kernel"] + b_dev["attention_hd_rows"],
                    "recompute_ms": b_dev["attention_hd_kernel"],
                    "forward_device_total": f_dev["total"], "backward_device_total": b_dev["total"],
                    "forward_events_ms": events_ms(fwd), "backward_events_ms": events_ms(bwd)}),
                    flush=True)
    print(json.dumps({"package": dense2sparse_vit_torch.__file__,
                      "card": card_name_and_power_limit()}), flush=True)


def compare(a: dict, b: dict) -> int:
    differ = 0
    for case, d in a["digests"].items():
        other = b["digests"].get(case)
        equal = other == d
        differ += not equal
        print(json.dumps({"case": case, "equal": equal, "missing": other is None}))
    print(json.dumps({"cases": len(a["digests"]), "differ": differ, "first": a["package"],
                      "second": b["package"], "cards": [a["card"], b["card"]]}))
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bits", metavar="OUT")
    ap.add_argument("--int8-times", action="store_true")
    ap.add_argument("--attn-bwd-times", action="store_true")
    ap.add_argument("--predictor-times", action="store_true")
    ap.add_argument("--hd-times", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    timing = args.int8_times or args.attn_bwd_times or args.predictor_times or args.hd_times
    if not (args.bits or timing or args.compare):
        ap.error("give --bits OUT, --int8-times, --attn-bwd-times, --predictor-times, "
                 "--hd-times or --compare A B")
    if args.compare:
        with open(args.compare[0]) as fa, open(args.compare[1]) as fb:
            return compare(json.load(fa), json.load(fb))
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("checkout_ab needs a CUDA device (or --device cpu for --bits)")
    device = torch.device(args.device)
    if timing:
        if device.type != "cuda":
            raise SystemExit("--int8-times, --attn-bwd-times, --predictor-times and --hd-times "
                             "time the card")
        if args.int8_times:
            int8_times(device)
        elif args.attn_bwd_times:
            attn_bwd_times(device)
        elif args.hd_times:
            hd_times(device)
        else:
            predictor_times(device)
        return 0
    result = measure(device)
    with open(args.bits, "w") as f:
        json.dump(result, f)
    print(json.dumps({"package": result["package"], "cases": len(result["digests"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
