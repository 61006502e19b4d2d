#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. build   the CUDA kernels of dense2sparse_vit_torch/csrc (nvcc, sm_90a);
  2. serve   batches of 1, 8 and 256 random NHWC images through the headline
             student (DeiT-S/16, 224 px, bf16, pruning 0.7/0.49/0.343 at
             blocks 3/6/9, small predictor) built by `create_model`, check
             the outputs and that each forward launched 12 block, 3
             predictor and 3 gather kernels;
  3. check   walk the model stage by stage at B=256 and hold every kernel
             against its plain torch version on the same activations (the
             block stage by stage: see `check_block`), then the unpruned
             forward against the plain torch model;
  4. time    each kernel against its plain version at every main-path shape,
             and the whole B=256 forward with kernels against without.
The line before the last is the kernels summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

SERVE_BATCHES = (1, 8, 256)
B_CHECK = 256
# Tolerances, bf16. Kernel and plain version round to bf16 (2^-8 relative)
# at different points (qkv, probabilities, the GELU input), so a few
# roundings compound. Each is relative to the largest magnitude of what is
# compared.
STAGE_TOL = 2e-2  # a block stage, the predictor's scores
# a residual stage x + branch: the kernel's error beyond the one bf16
# rounding of the sum, relative to the largest magnitude of the branch
BRANCH_TOL = 1e-2
BF16_U = 2.0 ** -8  # round-to-nearest bf16: |rn(z) - z| <= 2^-8 |z|
BLOCK_TOL = 2e-2  # the whole block output
LOGITS_TOL = 3e-2  # twelve blocks of such differences, unpruned forward
PER_FORWARD = {"fused_transformer_block": 12, "fused_predictor_lg": 3,
               "fused_gather_tokens": 3}
SOURCES = {
    "fused_transformer_block": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:198"),
    "fused_predictor_lg": (
        "dense2sparse_vit_torch/csrc/predictor.cu",
        "dense2sparse_vit_tpu/ops/pallas/predictor.py:242"),
    "fused_gather_tokens": (
        "dense2sparse_vit_torch/csrc/gather.cu",
        "dense2sparse_vit_tpu/ops/pallas/gather.py:121"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `iters` calls, CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def paired_ms(torch, kernel_fn, plain_fn, iters: int, rounds: int = 2):
    """Kernel and plain times, measured in turns: plain, kernel, kernel, plain."""
    k, p = [], []
    for _ in range(rounds):
        p.append(cuda_ms(torch, plain_fn, iters))
        k.append(cuda_ms(torch, kernel_fn, iters))
        k.append(cuda_ms(torch, kernel_fn, iters))
        p.append(cuda_ms(torch, plain_fn, iters))
    return statistics.median(k), statistics.median(p)


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) in fp32."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite values")
    return (got - want).abs().max().item(), want.abs().max().item()


def check_block(torch, x, w, num_heads, scale, ln_eps, block=None):
    """Hold the block kernel against its plain version, stage by stage.

    The block's output is x plus two branches, and at the init's weight
    scale the residual x is tens of times larger than the attention branch,
    so a wrong attention core would hide inside a tolerance on the output.
    Each stage of the kernel is compared with its plain version fed the
    kernel's own input to that stage:
      qkv, attn, hid: the LN1-qkv projection, the attention core and the
        GELU(fc1) activation, within STAGE_TOL;
      mid, out: x + proj(attn) and mid + fc2(hid), with the branch computed
        in fp32, within BRANCH_TOL once the one bf16 rounding of the sum is
        allowed for.
    The whole output is held against the plain block too (BLOCK_TOL). Prints
    the results, raises if a stage is out of tolerance, and returns the
    kernel's output and its max abs error.
    """
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import (
        attention_reference, layer_norm, linear, transformer_block_reference)

    y, st = ops.fused_transformer_block(
        x, w, num_heads, scale=scale, ln_eps=ln_eps, stages=True)
    h2 = layer_norm(st["mid"], w["ln2_w"], w["ln2_b"], ln_eps)
    plain = {
        "qkv": linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"]),
        "attn": attention_reference(st["qkv"], num_heads, scale),
        "hid": F.gelu(linear(h2, w["w1"], w["b1"]).float()).to(x.dtype),
    }
    rel = {}
    for name, want in plain.items():
        err, ref = rel_err(torch, st[name], want)
        rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
    residual = {"mid": (st["mid"], x, st["attn"], w["wproj"], w["bproj"]),
                "out": (y, st["mid"], st["hid"], w["w2"], w["b2"])}
    for name, (got, res, a, wt, b) in residual.items():
        branch = a.float() @ wt.float().t() + b
        z = res.float() + branch
        excess = ((got.float() - z).abs() - BF16_U * z.abs()).clamp(min=0)
        rel[name] = (excess.max().item() / max(branch.abs().max().item(), 1e-30),
                     BRANCH_TOL)
    err, ref = rel_err(torch, y, transformer_block_reference(x, w, num_heads, scale, ln_eps))
    rel["block"] = (err / ref, BLOCK_TOL)
    emit({"phase": "check", "kernel": "fused_transformer_block", "block": block,
          "shape": list(x.shape), "max_abs_err": err, "max_abs_ref": ref,
          "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"block kernel out of tolerance: {bad}")
    return y, err


def check_unpruned(torch, model, plain, images) -> None:
    """The unpruned forward has no selection, so the kernel model and the
    plain one agree up to bf16 rounding: hold the logits against each other."""
    got = model(images, unpruned=True).logits
    want = plain(images, unpruned=True).logits
    err, scale = rel_err(torch, got, want)
    emit({"phase": "serve_vs_plain", "batch": images.shape[0], "unpruned": True,
          "max_abs_err": err, "max_abs_ref": scale, "tol_rel": LOGITS_TOL})
    if err > LOGITS_TOL * max(scale, 1e-3):
        raise AssertionError(f"unpruned logits: max err {err} vs scale {scale}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, create_model
    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.ops.block import transformer_block_reference
    from dense2sparse_vit_torch.ops.gather import gather_tokens_reference
    from dense2sparse_vit_torch.ops.predictor import predictor_lg_reference
    from dense2sparse_vit_torch.ops.topk import topk_keep_indices
    from dense2sparse_vit_torch.utils import card_name_and_power_limit

    dev = torch.device("cuda", 0)
    smi = card_name_and_power_limit()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(dev)})

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    ptxas = [ln.strip() for ln in _cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})

    # ---- 2. serve through the entry point -------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0),
                         **HEADLINE_KWARGS).eval()
    plain = create_model(HEADLINE_MODEL, use_fused_attention=False, device=dev,
                         **HEADLINE_KWARGS).eval()
    plain.load_state_dict(model.state_dict())
    N = model.cfg.num_patches
    C = model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    images = {b: torch.randn((b, 224, 224, 3), generator=gen, device=dev,
                             dtype=torch.bfloat16) for b in SERVE_BATCHES}
    outputs = {}
    with torch.inference_mode():
        ops.reset_launch_counts()
        for b in SERVE_BATCHES:
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = model(images[b])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            if delta != PER_FORWARD:
                raise AssertionError(f"B={b}: launches {delta}, expected {PER_FORWARD}")
            shapes_ok = (
                out.logits.shape == (b, 1000)
                and out.features.shape == (b, keep[-1], C)
                and [t.shape[1] for t in out.pred_logits] == [N, keep[0], keep[1]]
                and int(out.kept_idx_orig.max()) < N
                and bool(torch.isfinite(out.logits.float()).all())
                and bool(torch.isfinite(out.features.float()).all())
            )
            if not shapes_ok:
                raise AssertionError(f"B={b}: bad outputs {out.logits.shape} "
                                     f"{out.features.shape}")
            outputs[b] = out
            emit({"phase": "serve", "batch": b, "launches": delta,
                  "logits": list(out.logits.shape),
                  "features": list(out.features.shape),
                  "pred_logits": [t.shape[1] for t in out.pred_logits],
                  "first_call_s": round(seconds, 4)})
        launches = ops.launch_counts()

    # ---- 3. every kernel against its plain version, stage by stage ------
    bf16 = torch.bfloat16
    errs = {k: 0.0 for k in PER_FORWARD}
    block_shapes, pred_shapes, gather_shapes = [], [], []
    x_in = images[B_CHECK]
    with torch.inference_mode():
        x = model.embed(x_in)
        p = 0
        for i, blk in enumerate(model.blocks):
            if i in model.pruning.pruning_locs:
                w = model.score_predictor[p].kernel_weights(bf16)
                xs = x[:, 1:]
                s_k = ops.fused_predictor_lg(xs, w)
                s_p = predictor_lg_reference(xs, w)
                err, scale = rel_err(torch, s_k, s_p)
                emit({"phase": "check", "kernel": "fused_predictor_lg",
                      "shape": list(xs.shape), "max_abs_err": err,
                      "max_abs_ref": scale, "tol_rel": STAGE_TOL})
                if err > STAGE_TOL * scale:
                    raise AssertionError(f"predictor stage {p}: err {err} scale {scale}")
                errs["fused_predictor_lg"] = max(errs["fused_predictor_lg"], err)
                pred_shapes.append((xs, w))
                probs = torch.softmax(s_k.float(), dim=-1).to(bf16)
                kept, _ = topk_keep_indices(probs, keep[p])
                idx = torch.cat([kept.new_zeros(B_CHECK, 1), kept + 1], dim=1)
                g_k = ops.fused_gather_tokens(x, idx)
                g_p = gather_tokens_reference(x, idx)
                if not torch.equal(g_k, g_p):
                    raise AssertionError(f"gather stage {p}: not bit-equal")
                gather_shapes.append((x, idx))
                emit({"phase": "check", "kernel": "fused_gather_tokens",
                      "shape": list(x.shape), "k": idx.shape[1],
                      "bit_equal": True})
                x = g_k
                p += 1
            w = blk.kernel_weights(bf16)
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            y, err = check_block(torch, x, w, *args, block=i)
            errs["fused_transformer_block"] = max(errs["fused_transformer_block"], err)
            if not block_shapes or block_shapes[-1][0].shape != x.shape:
                block_shapes.append((x, w, args))
            x = y
        # the walk ran the same kernels on the same inputs as the forward
        logits = model.head(model.norm(x)[:, 0])
        if not torch.equal(logits, outputs[B_CHECK].logits):
            raise AssertionError("stage walk and model forward disagree")
        emit({"phase": "check", "walk_equals_forward": True})
        # the whole model against the plain one, where no selection can differ
        check_unpruned(torch, model, plain, images[8])

    # ---- 4. time ---------------------------------------------------------
    timing = {k: {"ms": 0.0, "plain_ms": 0.0} for k in PER_FORWARD}
    with torch.inference_mode():
        for x, w, args in block_shapes:  # 3 blocks at each width
            k_ms, p_ms = paired_ms(
                torch,
                lambda: ops.fused_transformer_block(x, w, args[0], scale=args[1], ln_eps=args[2]),
                lambda: transformer_block_reference(x, w, *args), iters=10)
            n_calls = 3
            timing["fused_transformer_block"]["ms"] += n_calls * k_ms
            timing["fused_transformer_block"]["plain_ms"] += n_calls * p_ms
            emit({"phase": "time", "kernel": "fused_transformer_block",
                  "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms})
        for xs, w in pred_shapes:
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_predictor_lg(xs, w),
                lambda: predictor_lg_reference(xs, w), iters=10)
            timing["fused_predictor_lg"]["ms"] += k_ms
            timing["fused_predictor_lg"]["plain_ms"] += p_ms
            emit({"phase": "time", "kernel": "fused_predictor_lg",
                  "shape": list(xs.shape), "ms": k_ms, "plain_ms": p_ms})
        for x, idx in gather_shapes:
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_gather_tokens(x, idx),
                lambda: gather_tokens_reference(x, idx), iters=20)
            timing["fused_gather_tokens"]["ms"] += k_ms
            timing["fused_gather_tokens"]["plain_ms"] += p_ms
            emit({"phase": "time", "kernel": "fused_gather_tokens",
                  "shape": list(x.shape), "k": idx.shape[1],
                  "ms": k_ms, "plain_ms": p_ms})
        imgs = images[B_CHECK]
        f_ms, p_ms = paired_ms(torch, lambda: model(imgs), lambda: plain(imgs),
                               iters=5)
        emit({"phase": "time", "forward": "B=256 pruned student",
              "kernels_ms": f_ms, "plain_ms": p_ms,
              "kernels_img_per_s": B_CHECK / f_ms * 1e3,
              "plain_img_per_s": B_CHECK / p_ms * 1e3, "card": smi})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"]}
        for name in PER_FORWARD
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
