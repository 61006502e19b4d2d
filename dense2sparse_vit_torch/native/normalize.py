"""ctypes binding of the native uint8 -> float32 normalisation (port of
`dense2sparse_vit_tpu/native/normalize.py`).

`d2s_native.c`, beside this file, is compiled at the first call (never at
import) with the system C compiler (`cc -O3 -shared -fPIC ... -lpthread`)
into `dense2sparse_vit_torch/_build/libd2s_native_<hash>.so`, the hash that
of the source and the flags, so an edited source is rebuilt and an
unchanged one loaded as it is. Where no C compiler exists or the build
fails, `normalize_u8` takes its numpy version and warns once with the
reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "d2s_native.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_why_not: Optional[str] = None  # the reason the library is not used, once tried


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libd2s_native_{h}.so"


def _build(target: Path) -> None:
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise OSError("no C compiler (cc, gcc or clang) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / target.name
        run = subprocess.run([cc, *CFLAGS, "-o", str(so), str(SRC), "-lpthread"],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=120)
        if run.returncode != 0:
            raise OSError(f"{cc} failed on {SRC.name}:\n{run.stdout}")
        os.replace(so, target)  # atomic: concurrent builds each land a whole file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _why_not
    with _lock:
        if _lib is not None or _why_not is not None:
            return _lib
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            fn = lib.d2s_normalize_u8_to_f32_mt
            fn.restype = None
            fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                           ctypes.c_size_t, ctypes.c_size_t, ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            _why_not = str(e)
            warnings.warn(f"native normalisation unavailable, using numpy: {e}", stacklevel=3)
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded (builds it if need be)."""
    return _load() is not None


def normalize_u8_reference(img: np.ndarray, mean: Sequence[float],
                           std: Sequence[float]) -> np.ndarray:
    """The plain version: (x / 255 - mean) / std in float32 numpy."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (np.asarray(img).astype(np.float32) / 255.0 - mean) / std


def normalize_u8(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    """(..., C) uint8 -> float32 (x / 255 - mean) / std in one pass, as
    x * (1 / (255 std)) + (-mean / std): equal to the plain version to fp32
    rounding. The native library where it loads and C <= 8 (a call counted
    in `normalize_u8.native_calls`), else the plain version. The library
    splits an input of 65536 pixels or more over one thread a core (at
    most 16)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"normalize_u8 takes uint8, got {img.dtype}")
    C = img.shape[-1]
    lib = _load()
    if lib is None or C > 8:
        return normalize_u8_reference(img, mean, std)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale = np.ascontiguousarray(1.0 / (255.0 * std), np.float32)
    shift = np.ascontiguousarray(-mean / std, np.float32)
    out = np.empty(img.shape, np.float32)
    lib.d2s_normalize_u8_to_f32_mt(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_size_t(img.size // C), ctypes.c_size_t(C),
        scale.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        shift.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(os.cpu_count() or 1))
    normalize_u8.native_calls += 1
    return out


normalize_u8.native_calls = 0  # the calls that ran the library
