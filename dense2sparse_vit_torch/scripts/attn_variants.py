"""A/B of the attention half-block's inference schedules, on the card.

The port of the JAX package's `scripts/attn_variants.py`. It times the
shipped half-block forward x + proj(MHA(qkv(LN1 x))) (v0,
`ops.fused_attention_block`) and the three candidate attention cores of
`csrc/attn_variants.cu` (`ops.fused_attention_variant`) at the headline
student's stage widths (B=256, C=384, 6 heads, N = 197, 138, 97, 68), and
holds each against v0:

  v1  one pass over the keys with an online softmax (JAX: the pad-free
      softmax, fewer VPU passes per score);
  v2  v1 with the heads in pairs, both heads' scores from the sum and the
      difference of two K = 128 products (JAX: head pairing for the MXU);
  v3  all heads' QK^T, then all exps, then all P V, the scores staged in
      shared memory, or in a workspace where they outgrow it (JAX:
      two-phase).

A shape the variants do not take (`attention_variant_supported`: a head
wider than 127, or N past the half-block's ceiling) is printed as skipped.

Every variant takes the exact row-max softmax; the TPU variants'
exp(clip(s, -30, 30)) agrees with it inside |scaled logits| <= 30, where
these inputs lie (weights x0.05, x x0.5). Per (N, variant) it prints the ms
per call (CUDA events, `utils.profiling.time_call`), the MFU against the
H100's dense bf16 rate (989 TFLOP/s), max|diff vs v0| and the best variant,
with the card's name and power limit, and returns the rows (each with the
kernel launches its width and variant made, the base call included).

Usage (on the card):  python -m dense2sparse_vit_torch.scripts.attn_variants
CPU smoke:            python -m dense2sparse_vit_torch.scripts.attn_variants --device cpu
(the counterpart of JAX's --interpret: the plain versions at B=4, N=20,
C=96, 6 heads, 1 iteration; max|diff vs v0| only).
"""

from __future__ import annotations

import argparse

import torch

from dense2sparse_vit_torch.ops import entry_launches
from dense2sparse_vit_torch.ops.attention import (
    VARIANTS,
    attention_variant_supported,
    fused_attention_block,
    fused_attention_variant,
)
from dense2sparse_vit_torch.utils.profiling import time_call

PEAK_BF16 = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet)
B = 256
C = 384
HEADS = 6
STAGE_NS = (197, 138, 97, 68)


def make_params(c: int, device, seed: int = 0):
    """(ln_w, ln_b, wqkv, bqkv, wproj, bproj): the LayerNorm near 1 and 0,
    the rest N(0, 0.05^2); matrices (out, in) in bf16, the rest fp32."""
    gen = torch.Generator().manual_seed(seed)

    def n(*shape, s):
        return (torch.randn(shape, generator=gen) * s).to(device)

    ln_w = n(c, s=0.1) + 1.0
    ln_b = n(c, s=0.1)
    wqkv = n(3 * c, c, s=0.05).to(torch.bfloat16)
    bqkv = n(3 * c, s=0.05)
    wproj = n(c, c, s=0.05).to(torch.bfloat16)
    bproj = n(c, s=0.05)
    return ln_w, ln_b, wqkv, bqkv, wproj, bproj


def make_input(batch: int, n: int, c: int, device, seed: int = 1):
    gen = torch.Generator().manual_seed(seed + n)
    return (torch.randn((batch, n, c), generator=gen) * 0.5).to(device, torch.bfloat16)


def run_variant(variant, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads=HEADS,
                stages=False):
    """The half-block forward of `variant`: 0 the shipped kernel, 1-3 the
    candidate attention cores (the plain versions for CPU tensors). With
    `stages`, (out, {"qkv", "attn"})."""
    if variant == 0:
        return fused_attention_block(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                     stages=stages)
    return fused_attention_variant(variant, x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads,
                                   stages=stages)


def _launches() -> int:
    """Kernel launches so far, over every entry's counter of `ops`."""
    return entry_launches()


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu: the plain versions at tiny shapes")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--stages", default="", help="comma-separated N values (default: all four)")
    ap.add_argument("--variants", default="0,1,2,3", help="comma-separated variant ids to run")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("attn_variants: no CUDA device (pass --device cpu for the CPU smoke)")
    c = C if on_card else 96  # tiny channels on the CPU, as JAX's --interpret
    batch = B if on_card else 4
    iters = args.iters if on_card else 1
    stage_ns = STAGE_NS if on_card else (20,)
    if args.stages:
        stage_ns = tuple(int(s) for s in args.stages.split(","))
    variant_ids = tuple(int(s) for s in args.variants.split(","))
    unknown = set(variant_ids) - {0, *VARIANTS}
    if unknown:
        raise SystemExit(f"attn_variants: unknown variants {sorted(unknown)}")
    params = make_params(c, dev)
    if on_card:
        from dense2sparse_vit_torch.utils import card_name_and_power_limit

        print(f"card: {card_name_and_power_limit()}; MFU against {PEAK_BF16 / 1e12:.0f} "
              "TFLOP/s (dense bf16)", flush=True)

    rows = []
    with torch.inference_mode():
        for n in stage_ns:
            x = make_input(batch, n, c, dev)
            mark = _launches()  # v0's row counts the base call's launch too
            base, base_st = run_variant(0, x, *params, stages=True)
            # qkv (6BNC^2) + proj (2BNC^2) + two attention products (4BHN^2 d)
            flops = 8 * batch * n * c * c + 4 * batch * n * n * c
            print(f"\n== N={n} (B={batch}) ==", flush=True)
            times = {}
            for v in variant_ids:
                row = {"N": n, "B": batch, "variant": v, "launches": 0}
                rows.append(row)
                if v and on_card and not attention_variant_supported(v, n, HEADS, c // HEADS):
                    row["skipped"] = True
                    print(f"v{v}: skipped at N={n} (not taken at head width {c // HEADS})",
                          flush=True)
                    continue
                out, st = run_variant(v, x, *params, stages=True)
                err = (out.float() - base.float()).abs().max().item()
                row.update(max_diff_vs_v0=err, out_rel_vs_v0=_rel(out, base),
                           core_rel_vs_v0=_rel(st["attn"], base_st["attn"]))
                if not on_card:
                    print(f"v{v}: max|diff vs v0| = {err:.5f}", flush=True)
                    continue
                t = time_call(lambda: run_variant(v, x, *params), iters=iters,
                              repeats=args.repeats, device=dev)
                times[v] = t
                now = _launches()
                row.update(ms=t * 1e3, mfu=flops / t / PEAK_BF16, launches=now - mark)
                mark = now
                print(f"RESULT N={n} v{v}: {t * 1e3:7.3f} ms  MFU={row['mfu'] * 100:5.1f}%  "
                      f"max|diff vs v0|={err:.5f}", flush=True)
            if times:
                best = min(times, key=times.get)
                vs = f" ({times[0] / times[best]:.3f}x vs shipped)" if 0 in times else ""
                print(f"-> best at N={n}: v{best}{vs}", flush=True)
    return rows


if __name__ == "__main__":
    main()
