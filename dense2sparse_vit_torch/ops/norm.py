"""The block backward's LayerNorm backward and bias column sums, alone.

`csrc/norm.cu` holds the two reductions that every backward entry of
`csrc/block_bwd.cu` runs beside its GEMMs (the LayerNorm backward and the
`colsum` bias sums inside the TPU kernel
`dense2sparse_vit_tpu/ops/pallas/block.py::fused_transformer_block_backward`):

- `ln_backward`: for y = LN(x) * ln_w + ln_b and the fp32 cotangent dy of
  y, with x's row statistics (mean, 1/std) given,
  dx = rstd * (dz - mean(dz) - z * mean(dz * z)) + residual, where
  z = (x - mean) * rstd and dz = dy * ln_w, rounded once to bf16 (and kept
  in fp32 too with `fp32_copy`), and d_ln_w = sum dy * z, d_ln_b = sum dy
  over the rows, in fp32;
- `column_sums`: a (M, N) matrix's column sums in fp32, for bf16 or fp32.

For CUDA tensors they launch the kernels (`d2s_ln_backward`,
`d2s_column_sums`); for CPU tensors they run `ln_backward_reference` and
`column_sums_reference`, the plain versions. `ln_stats` gives the row
statistics the LayerNorm backward takes, as the kernels compute them.

The LayerNorm backward takes every C up to `LN_BWD_MAX_C`
(`ln_backward_takes`, `check_ln_width`: every backward entry of the block
kernels checks its C with them before it touches the device). The kernels
take rows of a multiple of 8 values: `ln_backward` pads any other C with
zero columns (zero ln_w there) and tells them the true width, over which
they take the means (`ops.rowpad`); `column_sums` pads N. Rows of a
multiple of 32 up to 768 values run `ln_bwd_kernel`, a row over the lanes
of a warp; every other width `ln_bwd_row_kernel`, a row over a whole CTA.

The kernels count their launches where they are launched, inside the
block backward's own entries too: `LN_BWD.launches` and
`COLUMN_SUMS.launches`, and of `LN_BWD`'s those on `ln_bwd_row_kernel`,
`LN_BWD_ROWS.launches` (0 until the kernels' library is loaded).
"""

from __future__ import annotations

import torch

from dense2sparse_vit_torch.ops import _cuda, rowpad


class LaunchCount:
    """A kernel's launches as the kernels' library counts them, read and
    reset through the C entry `entry` (which, value) (`which`: for
    d2s_norm_launches 0 the LayerNorm backward, 1 the column sums); setting
    it resets the library's count. 0 while the library is not loaded."""

    def __init__(self, which: int, entry: str = "d2s_norm_launches"):
        self.which = which
        self.entry = entry

    @property
    def launches(self) -> int:
        lib = _cuda.loaded()
        return 0 if lib is None else int(getattr(lib, self.entry)(self.which, -1))

    @launches.setter
    def launches(self, value: int) -> None:
        lib = _cuda.loaded()
        if lib is not None:
            getattr(lib, self.entry)(self.which, int(value))


LN_BWD = LaunchCount(0)
COLUMN_SUMS = LaunchCount(1)
LN_BWD_ROWS = LaunchCount(2)

# The widest row the LayerNorm backward takes: csrc/norm.cu's LN_BWD_MAX_C,
# 2 chunks of 4 columns on each of a CTA's 256 threads (the library's
# d2s_ln_backward_max_width).
LN_BWD_MAX_C = 2048


def ln_backward_takes(C: int) -> bool:
    """Whether the LayerNorm backward takes rows of C values: any C up to
    LN_BWD_MAX_C. Needs no card."""
    return 0 < C <= LN_BWD_MAX_C


def check_ln_width(C: int, what: str) -> None:
    """ValueError naming the ceiling where the LayerNorm backward, which
    every backward entry of the block kernels runs, does not take C (the
    padded width, where the entry pads its rows)."""
    if not ln_backward_takes(C):
        raise ValueError(f"{what}: C={C}: the LayerNorm backward takes rows of at most "
                         f"{LN_BWD_MAX_C} values")


def ln_stats(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(M, 2) fp32 (mean, 1/std) of x's rows, two-pass in fp32."""
    xf = x.reshape(-1, x.shape[-1]).float()
    mu = xf.mean(-1)
    rstd = torch.rsqrt(((xf - mu[:, None]) ** 2).mean(-1) + eps)
    return torch.stack([mu, rstd], -1)


def ln_backward_reference(dy, x, stats, ln_w, residual=None, fp32_copy=False):
    """Plain torch version of `ln_backward`, in fp32."""
    C = x.shape[-1]
    dy = dy.reshape(-1, C).float()
    mu, rstd = stats[:, :1], stats[:, 1:]
    z = (x.reshape(-1, C).float() - mu) * rstd
    dz = dy * ln_w.float()
    v = rstd * (dz - dz.mean(-1, keepdim=True) - z * (dz * z).mean(-1, keepdim=True))
    if residual is not None:
        v = v + residual.reshape(-1, C).float()
    d_ln_w, d_ln_b = (dy * z).sum(0), dy.sum(0)
    dx = v.to(torch.bfloat16)
    return (dx, v, d_ln_w, d_ln_b) if fp32_copy else (dx, d_ln_w, d_ln_b)


def ln_backward(dy: torch.Tensor, x: torch.Tensor, stats: torch.Tensor, ln_w: torch.Tensor,
                residual: torch.Tensor | None = None, fp32_copy: bool = False):
    """(dx (M, C) bf16[, dx fp32 with `fp32_copy`], d_ln_w (C,), d_ln_b (C,))
    for dy (M, C) fp32, x (M, C) bf16, stats (M, 2) fp32 (mean, 1/std; see
    `ln_stats`), ln_w (C,) fp32 and a residual (M, C) in bf16 or fp32 (or
    None) added to dx. The kernel takes any C up to LN_BWD_MAX_C, and raises
    on any other."""
    if x.device.type == "cpu":
        return ln_backward_reference(dy, x, stats, ln_w, residual, fp32_copy)
    what = "ln_backward"
    M, C = x.shape
    check_ln_width(C, what)
    Cp = rowpad.aligned(C)
    if Cp != C:  # zero columns past C, the means over C (ops.rowpad)
        pad = torch.nn.functional.pad
        got = rowpad.count(what, _ln_backward(
            pad(dy, (0, Cp - C)), pad(x, (0, Cp - C)), stats, pad(ln_w, (0, Cp - C)),
            None if residual is None else pad(residual, (0, Cp - C)), fp32_copy, C))
        return tuple(t[..., :C].contiguous() for t in got)
    return _ln_backward(dy, x, stats, ln_w, residual, fp32_copy, C)


def _ln_backward(dy, x, stats, ln_w, residual, fp32_copy, ln_c):
    """One d2s_ln_backward call at a width the kernels take."""
    what = "ln_backward"
    M, C = x.shape
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    lib = _cuda.library()
    nbytes = lib.d2s_ln_backward_workspace_bytes(M, C)
    if nbytes <= 0:
        raise ValueError(f"{what}: M={M}, C={C}: not taken by the kernel")
    res_b = residual if residual is not None and residual.dtype == bf16 else None
    res_f = residual if residual is not None and residual.dtype != bf16 else None
    ptrs = (_cuda.ptr(dy, "dy", dev, f32, (M, C)), _cuda.ptr(x, "x", dev, bf16, (M, C)),
            _cuda.ptr(stats, "stats", dev, f32, (M, 2)), _cuda.ptr(ln_w, "ln_w", dev, f32, (C,)),
            _cuda.ptr(res_b, "residual", dev, bf16, (M, C)),
            _cuda.ptr(res_f, "residual", dev, f32, (M, C)))
    dx = torch.empty((M, C), dtype=bf16, device=dev)
    dx_f = torch.empty((M, C), dtype=f32, device=dev) if fp32_copy else None
    d_ln_w, d_ln_b = (torch.empty((C,), dtype=f32, device=dev) for _ in range(2))
    work = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    err = lib.d2s_ln_backward(*ptrs, 0 if dx_f is None else dx_f.data_ptr(), dx.data_ptr(),
                              d_ln_w.data_ptr(), d_ln_b.data_ptr(), work.data_ptr(), M, C,
                              ln_c, _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_ln_backward")
    return (dx, dx_f, d_ln_w, d_ln_b) if fp32_copy else (dx, d_ln_w, d_ln_b)


def column_sums_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `column_sums`: the sums in fp32."""
    return a.float().sum(0)


def column_sums(a: torch.Tensor) -> torch.Tensor:
    """(N,) fp32 column sums of a (M, N), bf16 or fp32 (an N that is no
    multiple of 8 padded with zero columns, `ops.rowpad`)."""
    if a.device.type == "cpu":
        return column_sums_reference(a)
    M, N = a.shape
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"column_sums: {a.dtype} ({M}, {N}): the kernel takes bf16 or fp32")
    if N % 8:
        padded = torch.nn.functional.pad(a, (0, rowpad.aligned(N) - N))
        return rowpad.count("column_sums", column_sums(padded)[:N])
    dev, fp32 = a.device, int(a.dtype == torch.float32)
    lib = _cuda.library()
    work = torch.empty((lib.d2s_column_sums_workspace_bytes(M, N, fp32),), dtype=torch.uint8,
                       device=dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    err = lib.d2s_column_sums(_cuda.ptr(a, "a", dev, a.dtype, (M, N)), fp32, out.data_ptr(),
                              work.data_ptr(), M, N, _cuda.stream_handle(dev))
    _cuda.check(err, "d2s_column_sums")
    return out
