"""Token gather and its transpose, the scatter-add.

`fused_gather_tokens` is the port of
`dense2sparse_vit_tpu/ops/pallas/gather.py::fused_gather_tokens`:
out[b, k] = x[b, idx[b, k]], with a zero row where the index is < 0 or >= N.
It is differentiable in x: its backward is `fused_scatter_tokens`, the port
of the same file's `_fgt_bwd` (`_scatter_kernel`),
dx[b, n] = sum_k [idx[b, k] == n] * g[b, k], summed in fp32, where repeated
indices add up and out-of-range ones contribute nothing.

For CUDA tensors both launch `csrc/gather.cu`, rows of any width: rows
of 16-byte multiples in 16-byte vectors, any other row in the widest units
that divide it (the gather) or element by element (the scatter), counted
apart in `ops.rowpad.PADDED` as well; for CPU tensors they run
`gather_tokens_reference` and `scatter_tokens_reference`, the plain torch
versions of the same functions. The gather goes through the custom op
`d2s::gather_tokens` (a `cuda` implementation that launches the kernel and
counts the launch, a `cpu` one that runs the plain version, and a fake one
for `torch.export`).
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.ops import _cuda, rowpad

_SCATTER_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def gather_tokens_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch: (B, N, D) tokens by (B, K) indices -> (B, K, D)."""
    n = x.shape[1]
    valid = (idx >= 0) & (idx < n)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=x.dtype))


def scatter_tokens_reference(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch: (B, K, D) rows added into (B, n, D) zero rows at (B, K)
    indices, by `index_add_` on an fp32 buffer; the result in g.dtype."""
    B, K, D = g.shape
    valid = (idx >= 0) & (idx < n)
    # out-of-range indices add into one extra row per sample, dropped below
    rows = torch.where(valid, idx, torch.full_like(idx, n)).long()
    rows = rows + torch.arange(B, device=g.device)[:, None] * (n + 1)
    out = torch.zeros((B * (n + 1), D), dtype=torch.float32, device=g.device)
    out.index_add_(0, rows.reshape(-1), g.reshape(B * K, D).float())
    return out.view(B, n + 1, D)[:, :n].to(g.dtype)


def _check_pair(rows: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if rows.dim() != 3 or idx.dim() != 2 or idx.shape[0] != rows.shape[0]:
        raise ValueError(
            f"{what}: expected rows (B, *, D) and idx (B, K), got "
            f"{tuple(rows.shape)} and {tuple(idx.shape)}"
        )
    if rows.device.type != "cuda" or idx.device != rows.device:
        raise ValueError(
            f"{what}: rows on {rows.device} and idx on {idx.device}: need one "
            "CUDA device"
        )
    if idx.dtype != torch.int64:
        raise TypeError(f"{what}: idx must be int64, got {idx.dtype}")
    if not (rows.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{what}: rows and idx must be contiguous")
    row_bytes = rows.shape[2] * rows.element_size()
    if row_bytes % 16 == 0 and rows.data_ptr() % 16:
        raise ValueError(f"{what}: rows of {row_bytes} bytes must be 16-byte aligned")


@torch.library.custom_op("d2s::gather_tokens", mutates_args=(), device_types="cpu")
def _gather_op(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return gather_tokens_reference(x, idx)


@_gather_op.register_fake
def _(x, idx):
    return x.new_empty((x.shape[0], idx.shape[1], x.shape[2]))


@_gather_op.register_kernel("cuda")
def _launch_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_pair(x, idx, "fused_gather_tokens")
    B, N, D = x.shape
    K = idx.shape[1]
    out = torch.empty((B, K, D), dtype=x.dtype, device=x.device)
    err = _cuda.library().d2s_gather_rows(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, K,
        D * x.element_size(), _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "d2s_gather_rows")
    fused_gather_tokens.launches += 1
    if (D * x.element_size()) % 16:  # the narrow path
        rowpad.count("fused_gather_tokens")
    return out


def fused_scatter_tokens(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, K, D) rows scatter-added by (B, K) int64 indices into (B, n, D):
    the transpose of `fused_gather_tokens`, summed in fp32."""
    if g.device.type == "cpu":
        return scatter_tokens_reference(g, idx, n)
    _check_pair(g, idx, "fused_scatter_tokens")
    if g.dtype not in _SCATTER_DTYPES:
        raise TypeError(f"g has dtype {g.dtype}: the kernel takes bf16 or fp32")
    B, K, D = g.shape
    if n <= 0:
        raise ValueError(f"n={n}: need at least one output row")
    out = torch.empty((B, n, D), dtype=g.dtype, device=g.device)
    err = _cuda.library().d2s_scatter_rows(
        g.data_ptr(), idx.data_ptr(), out.data_ptr(), B, n, K, D,
        _SCATTER_DTYPES[g.dtype], _cuda.stream_handle(g.device),
    )
    _cuda.check(err, "d2s_scatter_rows")
    fused_scatter_tokens.launches += 1
    if D % 8:  # the narrow path
        rowpad.count("fused_scatter_tokens")
    return out


class _GatherTokens(torch.autograd.Function):
    """Gather forward, scatter-add backward; no gradient for the indices."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[1]
        return torch.ops.d2s.gather_tokens(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return fused_scatter_tokens(g.contiguous(), idx, ctx.n), None


def fused_gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) tokens gathered by (B, K) int64 indices -> (B, K, D)."""
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(
            f"expected x (B, N, D) and idx (B, K), got {tuple(x.shape)} and "
            f"{tuple(idx.shape)}"
        )
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherTokens.apply(x, idx)
    return torch.ops.d2s.gather_tokens(x, idx)  # no graph to record: skip the Function's host cost


fused_gather_tokens.launches = 0
fused_scatter_tokens.launches = 0
