"""Where the device time of the headline student's forward goes, by kernel.

    python -m dense2sparse_vit_torch.utils.profile_forward [--batch 256] [--plain]
        [--mode topk|threshold|attn|gumbel|t2t] [--quant int8]

Runs `--iters` forwards of `dynamic_vit_small_patch16_224_student` (bf16,
keep 0.7/0.49/0.343 at blocks 3/6/9, small predictor, random weights; with
`--mode threshold` the same student in threshold mode, with `--mode attn`
ranking by its own CLS rows, with `--mode gumbel` the gumbel baseline's eval
forward at the same ratios, with `--mode t2t` the pruned T2T-ViT-14
(`T2T_MODEL`, the same stages); the pruning student without capturing its CLS
rows where its mode does not rank by them; with `--quant int8`
the W8A8 blocks wherever the model quantizes, see `nn.layers.Block`) under
`torch.profiler` on the first CUDA device and prints one JSON line per
device kernel (calls and ms per forward, share of the device time), then a
summary line with the window's wall time per forward, the device's busy
share (kernel time over wall time) and the host's time to enqueue one
forward onto an idle device. `--plain` profiles the model without the
hand-written kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from dense2sparse_vit_torch.models import (
    ATTN_KWARGS, GUMBEL_KWARGS, GUMBEL_MODEL, HEADLINE_KWARGS, HEADLINE_MODEL, T2T_KWARGS,
    T2T_MODEL, THRESHOLD_KWARGS, create_model)
from dense2sparse_vit_torch.utils import card_name_and_power_limit

MODES = {
    "topk": (HEADLINE_MODEL, HEADLINE_KWARGS),
    "threshold": (HEADLINE_MODEL, THRESHOLD_KWARGS),
    "attn": (HEADLINE_MODEL, ATTN_KWARGS),
    "gumbel": (GUMBEL_MODEL, GUMBEL_KWARGS),
    "t2t": (T2T_MODEL, {k: v for k, v in T2T_KWARGS.items() if k != "use_fused_attention"}),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--mode", choices=sorted(MODES), default="topk")
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    if args.plain and args.quant != "none":
        raise SystemExit("--quant int8 runs through the kernels: it has no --plain model")
    dev = torch.device("cuda", 0)
    name, kwargs = MODES[args.mode]
    model = create_model(name, use_fused_attention=not args.plain, quant=args.quant, device=dev,
                         **kwargs).eval()
    x = torch.randn((args.batch, 224, 224, 3), device=dev, dtype=torch.bfloat16)
    kw = {} if args.mode == "gumbel" else {"collect_cls_attns": False}
    with torch.inference_mode():
        summary = profile_device(lambda: model(x, **kw), args.iters)
    print(json.dumps({"batch": args.batch, "mode": args.mode, "plain": args.plain,
                      "quant": args.quant, **summary,
                      "img_per_s": args.batch / summary["wall_ms"] * 1e3}))


def profile_device(fn, iters: int) -> dict:
    """Run fn 3 times to warm up, time the host's enqueue of one call onto an
    idle device, then profile `iters` calls: print one JSON line per device
    kernel (calls and ms per call of fn, share of the device time) and
    return the window's wall and device ms per call, the device's busy
    share, the median host enqueue ms and the card."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        fn()
    # host time to enqueue one call onto an idle device: where it exceeds
    # the device time, the host sets the pace
    host_ms = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    # device kernels, without the ranges that user annotations such as
    # Optimizer.step draw over them (their device time is the kernels')
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / iters
        print(json.dumps({"kernel": e.key[:120], "calls": e.count / iters,
                          "ms": ms, "share": ms / total if total else None}))
    return {"wall_ms": wall_ms, "device_ms": total, "busy_share": total / wall_ms,
            "host_enqueue_ms": statistics.median(host_ms),
            "card": card_name_and_power_limit()}


if __name__ == "__main__":
    main()
