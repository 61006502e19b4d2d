"""Kernel-timing entry points: `kernel_sweep` (the fused kernels at the
headline student's widths) and `attn_variants` (the attention half-block's
inference schedules v0-v3). Each runs on the card by default and takes
`--device cpu` for a smoke run of the plain versions at tiny shapes:

    python -m dense2sparse_vit_torch.scripts.kernel_sweep [--device cpu]
    python -m dense2sparse_vit_torch.scripts.attn_variants [--device cpu]
"""
