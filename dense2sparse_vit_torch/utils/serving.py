"""Batch-bucketed serving over exported artifacts.

The port of `dense2sparse_vit_tpu/utils/serving.py`. Requests arrive at
ragged batch sizes; `ServingModel` pads each one up to the nearest
configured bucket, runs that bucket's artifact (`utils/export.py`) and slices
the rows back, chunking a batch larger than the biggest bucket. Where the
symbolic-batch export succeeds, one artifact serves every size and no
padding is needed: a batch above the artifact's largest symbolic batch
(`utils.export.MAX_BATCH` when it was exported, kept in the manifest) is
served in chunks of that size. Which of the two a model holds is never hidden: `symbolic`
says it, and when the symbolic export failed and buckets were built
instead, `symbolic_error` holds why (and a warning said so).

    sm = ServingModel.export(student, buckets=(1, 8, 32, 256))
    sm.save("artifacts/")                  # ships without model code
    # serving process:
    sm = ServingModel.load("artifacts/")
    logits = sm(images)                    # any leading batch size
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from dense2sparse_vit_torch.utils import export
from dense2sparse_vit_torch.utils.export import export_student, load_exported

_MANIFEST = "manifest.json"
_SYMBOLIC = "symbolic.pt2"


def _bucket_file(b: int) -> str:
    return f"bucket_{b}.pt2"


class ServingModel:
    """Callable serving wrapper over one symbolic artifact or per-bucket ones."""

    def __init__(self, bucket_fns: Dict[int, Callable], bucket_blobs: Dict[int, bytes],
                 symbolic_fn: Optional[Callable] = None, symbolic_blob: Optional[bytes] = None,
                 symbolic_error: Optional[str] = None, max_batch: Optional[int] = None):
        if symbolic_fn is None and not bucket_fns:
            raise ValueError("need at least one bucket or a symbolic artifact")
        if symbolic_fn is not None and not (max_batch and max_batch > 0):
            raise ValueError(f"a symbolic artifact needs its largest batch, got {max_batch}")
        self.max_batch = max_batch  # the symbolic artifact's largest batch
        self._bucket_fns = dict(sorted(bucket_fns.items()))
        self._bucket_blobs = bucket_blobs
        self._symbolic_fn = symbolic_fn
        self._symbolic_blob = symbolic_blob
        self.symbolic_error = symbolic_error

    @property
    def symbolic(self) -> bool:
        """True when one symbolic-batch artifact serves every batch size."""
        return self._symbolic_fn is not None

    # -- construction ------------------------------------------------------

    @classmethod
    def export(cls, student, buckets: Sequence[int] = (1, 8, 32, 128), try_symbolic: bool = True,
               **export_kwargs) -> "ServingModel":
        """Export the student once symbolically or, if that fails or
        `try_symbolic` is False, once per bucket."""
        error = None
        if try_symbolic:
            try:
                blob = export_student(student, batch_size=None, **export_kwargs)
                return cls({}, {}, load_exported(blob), blob, max_batch=export.MAX_BATCH)
            except Exception as e:  # the symbolic trace is refused: fall back, and say so
                error = f"{type(e).__name__}: {e}"
                warnings.warn(f"symbolic-batch export failed, exporting buckets {tuple(buckets)} "
                              f"instead: {error[:500]}", stacklevel=2)
        if not buckets:
            raise ValueError(f"no symbolic artifact ({error}) and no buckets")
        blobs = {b: export_student(student, batch_size=b, **export_kwargs)
                 for b in sorted({int(b) for b in buckets})}
        return cls({b: load_exported(blob) for b, blob in blobs.items()}, blobs,
                   symbolic_error=error)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        manifest = {"buckets": sorted(self._bucket_blobs), "symbolic": self.symbolic}
        if self.symbolic:
            manifest["max_batch"] = self.max_batch
        if self.symbolic_error is not None:
            manifest["symbolic_error"] = self.symbolic_error
        if self.symbolic:
            with open(os.path.join(path, _SYMBOLIC), "wb") as f:
                f.write(self._symbolic_blob)
        for b, blob in self._bucket_blobs.items():
            with open(os.path.join(path, _bucket_file(b)), "wb") as f:
                f.write(blob)
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f)

    @classmethod
    def load(cls, path: str) -> "ServingModel":
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        symbolic_fn = symbolic_blob = None
        if manifest["symbolic"]:
            with open(os.path.join(path, _SYMBOLIC), "rb") as f:
                symbolic_blob = f.read()
            symbolic_fn = load_exported(symbolic_blob)
        blobs = {}
        for b in manifest["buckets"]:
            with open(os.path.join(path, _bucket_file(b)), "rb") as f:
                blobs[int(b)] = f.read()
        return cls({b: load_exported(blob) for b, blob in blobs.items()}, blobs,
                   symbolic_fn, symbolic_blob, manifest.get("symbolic_error"),
                   manifest.get("max_batch"))

    # -- dispatch ----------------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(self._bucket_fns)

    def _bucket_for(self, n: int) -> int:
        for b in self._bucket_fns:  # sorted ascending
            if b >= n:
                return b
        return max(self._bucket_fns)

    def __call__(self, images) -> torch.Tensor:
        """images: (B, H, W, 3), any B >= 1 -> (B, num_classes) fp32 logits
        on the artifacts' device."""
        images = torch.as_tensor(images, dtype=torch.float32)
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if self.symbolic:
            step = self.max_batch
            return torch.cat([self._symbolic_fn(images[i:i + step]) for i in range(0, n, step)])
        out, i = [], 0
        while i < n:
            b = self._bucket_for(n - i)
            chunk = images[i:i + b]
            take = chunk.shape[0]
            if take < b:  # pad the tail request up to the bucket
                pad = chunk.new_zeros((b - take,) + tuple(images.shape[1:]))
                chunk = torch.cat([chunk, pad])
            out.append(self._bucket_fns[b](chunk)[:take])
            i += take
        return torch.cat(out)
