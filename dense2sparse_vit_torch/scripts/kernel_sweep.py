"""Times the port's fused kernels at the headline student's widths, on the card.

The port of the JAX package's `scripts/kernel_sweep.py`. It times the
attention half-block forward, the MLP half forward and the whole block
forward at --batch, and the whole block's backward at --train-batch, at the
per-stage sequence lengths of the keep-0.7/0.49/0.343 schedule (N = 197,
138, 97, 68), and prints a markdown table of ms per call (CUDA events,
`utils.profiling.time_call`) and bf16 MFU against the H100's dense 989
TFLOP/s, headed by the card's name and power limit, which it also writes to
--out (`kernel_sweep.md` in the temporary directory by default, /tmp as in
JAX where TMPDIR is unset). It returns the rows, each with the kernel
launches its timing made (the entries', not the LayerNorm backward and
column sums that the backward entries launch inside).

MFU counts algorithmic matmul FLOPs, as JAX does: 8BNC^2 + 4BN^2C for the
attention half, 16BNC^2 for the MLP half, and a backward twice its forward
(the forward it recomputes is overhead, not useful work).

The port adds the half-block's backward at --train-batch, in plain mode
(attn_half_bwd) and in policy mode with dPolicy on a seeded keep mask of
~0.7 (attn_half_bwd[policy]): in the JAX package only its custom VJP and
its tests reach those kernels. JAX's --block-batches and its "best
block_batch" line are gone: block_batch is how many samples one step of the
TPU grid holds in VMEM, a tiling the port's kernels have no counterpart of
(their CTAs tile token rows, heads and query tiles on their own).

Usage (on the card):  python -m dense2sparse_vit_torch.scripts.kernel_sweep
CPU smoke:            python -m dense2sparse_vit_torch.scripts.kernel_sweep --device cpu
(JAX's --interpret: the plain versions at B=8, N=32, 2 iterations; no MFU).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.utils.profiling import time_call

PEAK_BF16 = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet)
KERNELS = ("attn", "attn_bwd", "mlp", "block", "block_bwd")


def make_params(c: int, hidden: int, device, seed: int = 0) -> dict:
    """A block's weights as JAX's sweep draws them: unit LayerNorms, zero
    biases, matrices 0.02 N(0, 1) (out, in) in bf16; LayerNorms and biases
    fp32, as the kernels take them."""
    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (0.02 * torch.randn(shape, generator=gen)).to(device, torch.bfloat16)

    def f32(n, value=0.0):
        return torch.full((n,), value, device=device)

    return {"ln1_w": f32(c, 1.0), "ln1_b": f32(c), "wqkv": w(3 * c, c), "bqkv": f32(3 * c),
            "wproj": w(c, c), "bproj": f32(c), "ln2_w": f32(c, 1.0), "ln2_b": f32(c),
            "w1": w(hidden, c), "b1": f32(hidden), "w2": w(c, hidden), "b2": f32(c)}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu: the plain versions at tiny shapes")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--train-batch", type=int, default=128)
    p.add_argument("--embed-dim", type=int, default=384)
    p.add_argument("--num-heads", type=int, default=6)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--seq-lens", type=int, nargs="+", default=[197, 138, 97, 68])
    p.add_argument("--kernels", nargs="+", default=list(KERNELS), choices=KERNELS)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "kernel_sweep.md"))
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: no CUDA device (pass --device cpu for the CPU smoke)")
    if not on_card:
        args.batch = args.train_batch = 8
        args.seq_lens = [32]
        args.iters, args.repeats = 2, 1

    c, h = args.embed_dim, args.num_heads
    hidden = 4 * c
    w = make_params(c, hidden, dev)
    attn_w = [w[k] for k in ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")]
    mlp_w = [w[k] for k in ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")]
    gen = torch.Generator().manual_seed(1)
    if on_card:
        from dense2sparse_vit_torch.utils import card_name_and_power_limit

        head = (f"card: {card_name_and_power_limit()}; ms per call by CUDA events, MFU "
                f"against {PEAK_BF16 / 1e12:.0f} TFLOP/s (dense bf16)")
    else:
        head = "CPU smoke: the plain versions, ms per call by perf_counter; no MFU"
    lines = [head, "", "| kernel | B | N | ms/call | MFU |", "|---|---|---|---|---|"]
    print(head, flush=True)
    rows = []

    def record(kind, batch, n, fn, flops):
        before = ops.entry_launches()
        s = time_call(fn, iters=args.iters, repeats=args.repeats, device=dev)
        mfu = flops / s / PEAK_BF16 if on_card else None
        rows.append({"kernel": kind, "B": batch, "N": n, "ms": s * 1e3, "mfu": mfu,
                     "launches": ops.entry_launches() - before})
        lines.append(f"| {kind} | {batch} | {n} | {s * 1e3:.3f} | "
                     f"{'not measured' if mfu is None else f'{mfu:.1%}'} |")
        print(lines[-1], flush=True)

    with torch.no_grad():  # the CPU backward's plain version runs autograd inside
        for n in args.seq_lens:
            xi = (0.02 * torch.randn((args.batch, n, c), generator=gen)).to(dev, torch.bfloat16)
            xt = xi[: args.train_batch].contiguous()
            g = torch.ones_like(xt)
            pol = (torch.rand((args.train_batch, n), generator=gen) < 0.7).float().to(dev)
            pol[:, 0] = 1.0
            f_attn = 8 * args.batch * n * c * c + 4 * args.batch * n * n * c
            f_mlp = 16 * args.batch * n * c * c
            scale_t = args.train_batch / args.batch
            if "attn" in args.kernels:
                record("attn_half_fwd", args.batch, n,
                       lambda: ops.fused_attention_block(xi, *attn_w, h), f_attn)
            if "attn_bwd" in args.kernels:
                record("attn_half_bwd", args.train_batch, n,
                       lambda: ops.fused_attention_block_backward(xt, g, *attn_w[:5], h),
                       2 * f_attn * scale_t)
                record("attn_half_bwd[policy]", args.train_batch, n,
                       lambda: ops.fused_attention_block_backward_policy(
                           xt, g, pol, *attn_w[:5], h), 2 * f_attn * scale_t)
            if "mlp" in args.kernels:
                record("mlp_half_fwd", args.batch, n,
                       lambda: ops.fused_mlp_residual(xi, *mlp_w), f_mlp)
            if "block" in args.kernels:
                record("block_fwd", args.batch, n,
                       lambda: ops.fused_transformer_block(xi, w, h), f_attn + f_mlp)
            if "block_bwd" in args.kernels:
                record("block_bwd", args.train_batch, n,
                       lambda: ops.fused_transformer_block_backward(xt, g, w, h),
                       2 * (f_attn + f_mlp) * scale_t)

    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"table written to {args.out}", flush=True)
    return rows


if __name__ == "__main__":
    main()
