"""Ahead-of-time export of a student's eval forward for serving.

The port of `dense2sparse_vit_tpu/utils/export.py`: `torch.export` traces the
student's eval forward (images -> fp32 logits, the images cast to the
model's compute dtype inside) into an `ExportedProgram`, serialised to
bytes, which a serving process loads and calls without the model code. The
batch dimension may be symbolic, so that one artifact serves every batch
size.

    blob = export_student(student, batch_size=None)      # symbolic batch
    open("student.pt2", "wb").write(blob)
    # serving side:
    fn = load_exported("student.pt2")
    logits = fn(images)                                  # any batch

The kernels are not inside the artifact: each is a `d2s::*` custom op
(`dense2sparse_vit_torch.ops`), which the graph calls by name. Loading
imports `dense2sparse_vit_torch.ops` to register them, and never the model
code (`dense2sparse_vit_torch.models`); an artifact exported on the card
runs its ops' CUDA implementations there. Unlike a `jax.export` blob, which
embeds its lowered kernels, an artifact needs the port's op library (and,
for its CUDA ops, a card and nvcc) to run.

The weights travel in the artifact: the parameters, and the compute-dtype
copies and int8 codes the modules keep as buffers (`nn.layers.
cached_tensors`), which one eager call before tracing brings up to date, so
that the exported graph casts and quantizes nothing per call.
"""

from __future__ import annotations

import inspect
import io
from typing import Callable, Optional

import torch
import torch.nn as nn

import dense2sparse_vit_torch.ops  # noqa: F401  (registers the d2s:: custom ops)

# torch.export's largest symbolic batch: an upper bound the graph may assume
MAX_BATCH = 4096


class _EvalForward(nn.Module):
    """images (B, H, W, 3) -> fp32 logits, through the student's eval forward."""

    def __init__(self, student: nn.Module):
        super().__init__()
        self.student = student
        # the pruning student's serving forward captures no CLS rows (JAX
        # `export.py:74`); the gumbel baseline has no such switch
        params = inspect.signature(student.forward).parameters
        self.kwargs = {"collect_cls_attns": False} if "collect_cls_attns" in params else {}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = getattr(torch, self.student.cfg.dtype)
        return self.student(images.to(dtype), **self.kwargs).logits.float()


def export_student(student: nn.Module, batch_size: Optional[int] = None,
                   img_size: Optional[int] = None) -> bytes:
    """Serialise the student's eval forward (images -> fp32 logits).

    student: a `DiffPruningStudent` (top-k or threshold, bf16 or int8) or a
      `DynamicViTStudent`, on the device the artifact is to run on; it is
      put in eval mode.
    batch_size: a fixed batch, or None for a symbolic batch dimension.
    img_size: the input resolution; defaults to the student's.
    Returns the artifact's bytes (`torch.export.save`).
    """
    pr = getattr(student, "pruning", None)
    if pr is not None and pr.cls_from_teacher:
        # the JAX export's guard: the teacher's CLS rows would be a runtime input
        raise ValueError("cls_from_teacher students take the frozen teacher's CLS "
                         "attentions as a runtime input; export the "
                         "teacher-independent configuration instead")
    size = img_size or student.cfg.img_size
    device = next(student.parameters()).device
    student.eval()
    fwd = _EvalForward(student)
    example = torch.zeros((batch_size or 2, size, size, 3), device=device)
    dynamic = None
    if batch_size is None:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        fwd(example)  # brings every cached weight copy up to date
        exported = torch.export.export(fwd, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(path_or_bytes) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an artifact (a path or its bytes); returns images -> fp32
    logits. The images go to the artifact's device and to fp32."""
    blob = path_or_bytes
    if not isinstance(blob, (bytes, bytearray)):
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    module = torch.export.load(io.BytesIO(bytes(blob))).module()
    device = next(iter(module.state_dict().values())).device

    def fn(images) -> torch.Tensor:
        images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        with torch.inference_mode():
            return module(images)

    return fn
