"""The port's native normaliser (`dense2sparse_vit_torch/native/`) against
the JAX package's: the same C source and flags, so the outputs are bit-equal;
against numpy to fp32 rounding. It builds under the port's `_build/` and
writes nothing into the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dense2sparse_vit_tpu.core.config import DataConfig as JaxDataConfig
from dense2sparse_vit_tpu.data import pipeline as jax_pipeline
from dense2sparse_vit_tpu.native import normalize_u8 as jax_normalize_u8

from dense2sparse_vit_torch.core.config import DataConfig
from dense2sparse_vit_torch.data import pipeline
from dense2sparse_vit_torch.native import normalize as native
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _batch(shape=(3, 20, 24, 3), seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(3, 20, 24, 3), (256, 3), (2, 300, 300, 3), (5, 7, 4)])
def test_normalize_u8_equals_jax_bit_for_bit(shape):
    """(2, 300, 300, 3) takes the threaded path (>= 65536 pixels); C = 4
    the general loop."""
    x = _batch(shape)
    mean, std = MEAN + (0.5,) * (shape[-1] - 3), STD + (0.25,) * (shape[-1] - 3)
    assert native.native_available()
    got = native.normalize_u8(x, mean, std)
    want = jax_normalize_u8(x, mean, std)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)


def test_normalize_u8_within_two_ulps_of_numpy():
    """Every uint8 value in every channel: x * (1 / (255 std)) - mean / std
    against numpy's (x / 255 - mean) / std, within two ulps of the largest
    output (|y| <= 2.64, ulp 2.4e-7)."""
    x = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    got = native.normalize_u8(x, MEAN, STD)
    want = native.normalize_u8_reference(x, MEAN, STD)
    ulp = np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= 2 * ulp
    calls = native.normalize_u8.native_calls
    native.normalize_u8(x, MEAN, STD)
    assert native.normalize_u8.native_calls == calls + 1


def test_the_pipeline_takes_the_native_kernel_as_jax_does():
    x = _batch()
    calls = native.normalize_u8.native_calls
    got = pipeline._normalize(x, DataConfig())
    assert native.normalize_u8.native_calls == calls + 1
    np.testing.assert_array_equal(got, jax_pipeline._normalize(x, JaxDataConfig()))
    f = x.astype(np.float32)  # float input keeps the numpy path on both sides
    np.testing.assert_array_equal(pipeline._normalize(f, DataConfig()),
                                  jax_pipeline._normalize(f, JaxDataConfig()))


def test_builds_under_the_port_and_not_in_the_jax_package(tmp_path):
    """A fresh process builds from a copy of the source (its own hash) into
    the port's _build/, and leaves the JAX package's directory as it was."""
    jax_dir = os.path.join(REPO, "dense2sparse_vit_tpu", "native")
    before = {f: os.stat(os.path.join(jax_dir, f)).st_mtime_ns for f in os.listdir(jax_dir)}
    code = (
        "import sys, numpy as np\n"
        "from dense2sparse_vit_torch.native import normalize as n\n"
        "n.SRC = __import__('pathlib').Path(sys.argv[1])\n"
        "p = n.library_path()\n"
        "assert not p.exists()\n"
        "x = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)\n"
        "n.normalize_u8(x, (0.5,) * 3, (0.25,) * 3)\n"
        "assert n.normalize_u8.native_calls == 1 and p.exists(), p\n"
        "p.unlink()\n"
        "print(p.parent)\n"
    )
    src = tmp_path / "d2s_native.c"
    src.write_text(native.SRC.read_text() + f"\n/* {tmp_path.name} */\n")
    out = subprocess.run([sys.executable, "-c", code, str(src)], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120).stdout.strip()
    assert out == os.path.join(REPO, "dense2sparse_vit_torch", "_build")
    after = {f: os.stat(os.path.join(jax_dir, f)).st_mtime_ns for f in os.listdir(jax_dir)}
    assert after == before


def test_no_compiler_warns_once_and_takes_numpy(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why_not", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "library_path", lambda: native.BUILD_DIR / "absent.so")
    x = _batch()
    with pytest.warns(UserWarning, match="no C compiler"):
        got = native.normalize_u8(x, MEAN, STD)
    np.testing.assert_array_equal(got, native.normalize_u8_reference(x, MEAN, STD))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        native.normalize_u8(x, MEAN, STD)  # no second warning
