"""Token gather: rows of x selected by per-sample indices.

`fused_gather_tokens` is the port of
`dense2sparse_vit_tpu/ops/pallas/gather.py::fused_gather_tokens` (forward):
out[b, k] = x[b, idx[b, k]], with a zero row where the index is < 0 or >= N.
For a CUDA tensor it launches `csrc/gather.cu`; for a CPU tensor it runs
`gather_tokens_reference`, the plain torch version of the same function.
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.ops import _cuda


def gather_tokens_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch: (B, N, D) tokens by (B, K) indices -> (B, K, D)."""
    n = x.shape[1]
    valid = (idx >= 0) & (idx < n)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=x.dtype))


def fused_gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) tokens gathered by (B, K) int64 indices -> (B, K, D)."""
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(
            f"expected x (B, N, D) and idx (B, K), got {tuple(x.shape)} and "
            f"{tuple(idx.shape)}"
        )
    if x.device.type == "cpu":
        return gather_tokens_reference(x, idx)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"x on {x.device} and idx on {idx.device}: need one CUDA device")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_gather_tokens has no backward kernel yet")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    B, N, D = x.shape
    K = idx.shape[1]
    row_bytes = D * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"rows of {row_bytes} bytes: need a 16-byte multiple, aligned")
    out = torch.empty((B, K, D), dtype=x.dtype, device=x.device)
    lib = _cuda.library()
    err = lib.d2s_gather_rows(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, K, row_bytes,
        _cuda.stream_handle(x.device),
    )
    _cuda.check(err, "d2s_gather_rows")
    fused_gather_tokens.launches += 1
    return out


fused_gather_tokens.launches = 0
