"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into an object (all
files at once, one process each) and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. Nothing is built at import: the first
call of `library()` builds, which needs `nvcc` and therefore runs only where
there is a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "d2s_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "d2s_scatter_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "d2s_block_forward": [_P] * 25 + [_I] * 6 + [_F] * 3 + [_P],
    "d2s_block_backward": [_P] * 32 + [_I] * 6 + [_F] * 3 + [_P],
    "d2s_block_backward_scratch_bytes": [_I] * 6,
    "d2s_block_int8_forward": [_P] * 30 + [_I] * 6 + [_F] * 2 + [_P],
    "d2s_attention_packed_forward": [_P, _L, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "d2s_attention_packed_backward": [_P, _L, _I] + [_P] * 9 + [_I] * 4 + [_F] * 2 + [_P],
    "d2s_attention_bwd_part_floats": [_I] * 6,
    "d2s_attention_max_tokens": [_I] * 3,
    "d2s_mlp_residual_forward": [_P] * 10 + [_I] * 4 + [_F, _P],
    "d2s_mlp_residual_backward": [_P] * 15 + [_I] * 4 + [_F, _P],
    "d2s_mlp_residual_backward_scratch_bytes": [_I] * 3,
    "d2s_attention_block_forward": [_P] * 14 + [_I] * 5 + [_F] * 3 + [_P],
    "d2s_attention_block_backward": [_P] * 17 + [_I] * 5 + [_F] * 3 + [_P],
    "d2s_attention_block_backward_scratch_bytes": [_I] * 5,
    "d2s_attention_variant_forward": [_P] * 12 + [_I] * 6 + [_F] * 2 + [_P],
    "d2s_attention_variant_supported": [_I] * 4,
    "d2s_attention_variant_scratch_bytes": [_I] * 5,
    "d2s_ln_gemm": [_P, _I, _L, _P, _I, _P, _P, _P, _F, _I, _P, _P, _P, _I, _P, _P, _P, _P]
                   + [_I] * 4 + [_P],
    "d2s_wgrad": [_P] * 5 + [_I] * 3 + [_P],
    "d2s_qgemm": [_P] * 9 + [_I] * 4 + [_P],
    "d2s_rowq": [_P, _I, _P, _P, _F, _P, _P, _I, _I, _I, _P],
    "d2s_rowq_max_width": [],
    "d2s_quant_launches": [_I, _L],
    "d2s_wgrad_workspace_bytes": [_I] * 3,
    "d2s_ln_backward": [_P] * 11 + [_I] * 3 + [_P],
    "d2s_ln_backward_workspace_bytes": [_I] * 2,
    "d2s_ln_backward_max_width": [],
    "d2s_column_sums": [_P, _I, _P, _P, _I, _I, _P],
    "d2s_column_sums_workspace_bytes": [_I] * 3,
    "d2s_norm_launches": [_I, _L],
    "d2s_attention_bwd_launches": [_I, _L],
    "d2s_attention_hd_launches": [_I, _L],
    "d2s_attention_hd_dp_launches": [_I, _I, _I, _L],
    "d2s_predictor_forward": (
        [_P, _L, _P, _P, _L, _I, _I, _I, _I, _I, _P] + [_P] * 4 + [_P] * 4 + [_I, _F, _P]
    ),
    "d2s_predictor_scratch_bytes": [_I] * 5 + [_P],
}

_RESTYPES = {"d2s_block_backward_scratch_bytes": _L, "d2s_wgrad_workspace_bytes": _L,
             "d2s_mlp_residual_backward_scratch_bytes": _L,
             "d2s_attention_block_backward_scratch_bytes": _L,
             "d2s_ln_backward_workspace_bytes": _L, "d2s_column_sums_workspace_bytes": _L,
             "d2s_norm_launches": _L, "d2s_quant_launches": _L,
             "d2s_attention_bwd_launches": _L,
             "d2s_attention_hd_launches": _L, "d2s_attention_hd_dp_launches": _L,
             "d2s_predictor_scratch_bytes": _L, "d2s_attention_bwd_part_floats": _L,
             "d2s_attention_variant_scratch_bytes": _L}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output, with ptxas's register and spill counts


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> str:
    """Compile every source in parallel, link into `target`; return the log."""
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        os.replace(so, target)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from `csrc/` on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libd2s_kernels_{_digest()}.so"
            log = target.with_suffix(".log")
            if not target.exists():
                log.write_text(_build(target))
            build_log = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib


def loaded() -> ctypes.CDLL | None:
    """The kernels' library if `library()` has loaded it, else None (no build)."""
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t, name: str, device, dtype, shape) -> int:
    """Data pointer of `t` after checking device, dtype, shape, contiguity
    and 16-byte alignment; 0 (a null pointer) for t=None."""
    if t is None:
        return 0
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t.data_ptr()
