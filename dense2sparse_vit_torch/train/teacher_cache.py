"""Frozen-teacher output cache (port of
`dense2sparse_vit_tpu/train/teacher_cache.py`).

The teacher never trains, so on a deterministic input view its outputs per
sample are constants: one pre-pass computes them, and every later train
step looks them up instead of running the teacher's forward. That holds
only when a sample's teacher input is the same every epoch: mixup and
cutmix must be off (the teacher sees the mixed images, which change every
step; `run_experiment` refuses both together), and the stochastic
augmentations too, so the cache trains on the eval view.

Per image (bf16): logits 2 KB, the final tokens' softmax (the same bytes as
the tokens) with a 784 B fp32 entropy row, and the reduced (N,) mask-loss
target (392 B); ~0.15 MB in all.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.config import ExperimentConfig
from dense2sparse_vit_torch.losses.mask_loss import aggregate_teacher_cls_attn
from dense2sparse_vit_torch.train.train_step import prepare_images


def make_teacher_outputs_fn(teacher: nn.Module, cfg: ExperimentConfig):
    """`fn(images) -> dict` of the cacheable teacher outputs, computed
    without gradients on the images' device (uint8 images are normalised
    there first). Keys: 'logits' (B, num_classes); 'target' (B, N), the
    reduced mask-loss supervision, or 'attns' (B, L, H, N+1) where the
    student reads the whole stack (cls_from_teacher); and the final tokens
    in the form their loss reads: 'token_probs' (B, N, D), softmax(tokens),
    and 'token_entropy' (B, N), sum(q log q) in fp32, for the pruning
    student's token KL; the raw 'tokens' (B, N, D) for the gumbel baseline's
    token distillation. Rows are stored in bf16 for a bf16 model and in
    fp32 otherwise."""
    need_stack = cfg.pruning.cls_from_teacher
    raw_tokens = cfg.pruning.selection == "gumbel"
    store_dt = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32

    @torch.no_grad()
    def fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = prepare_images(images, cfg)
        teacher.eval()
        t_logits, t_tokens, t_attns = teacher(images)
        out = {"logits": t_logits.to(store_dt)}
        if raw_tokens:
            out["tokens"] = t_tokens.to(store_dt)
        else:
            logq = F.log_softmax(t_tokens.float(), dim=-1)
            q = torch.exp(logq)
            out["token_probs"] = q.to(store_dt)
            out["token_entropy"] = torch.sum(q * logq, dim=-1)
        if need_stack:
            out["attns"] = t_attns.to(store_dt)
        else:
            out["target"] = aggregate_teacher_cls_attn(t_attns, cfg.pruning.mean_heads).to(store_dt)
        return out

    return fn


class TeacherCache:
    """Host store of the teacher's outputs for a train split, keyed by
    dataset index; `to_device` moves it to the card, where batches are
    gathered by index. The host store is torch tensors (numpy has no bf16),
    in pinned memory where a CUDA device is present."""

    def __init__(self, indices):
        self._pos = {int(i): r for r, i in enumerate(indices)}
        self._store: Dict[str, torch.Tensor] = {}
        self.filled = np.zeros(len(self._pos), bool)
        self._dev: Optional[Dict[str, torch.Tensor]] = None

    def build(self, outputs_fn, loader, batch_size: int, device, cache_images: bool = False):
        """One pre-pass over `loader` (which must yield (images, labels,
        indices)), the teacher on `device`. A short last batch is padded
        with copies of its first row up to batch_size and the pad rows are
        dropped after the forward. cache_images: store the uint8 images and
        labels too, so that `to_device` can make the whole epoch resident."""
        device = torch.device(device)
        pin = torch.cuda.is_available()
        for xb, yb, sel in loader():
            n = len(sel)
            xb = torch.as_tensor(xb)
            if n < batch_size:
                xb = torch.cat([xb, xb[:1].expand(batch_size - n, *xb.shape[1:])])
            out = {k: v[:n].cpu() for k, v in outputs_fn(xb.to(device)).items()}
            if cache_images:
                out["images"] = xb[:n]
                out["labels"] = torch.as_tensor(yb, dtype=torch.int32)
            rows = torch.as_tensor([self._pos[int(i)] for i in sel], dtype=torch.long)
            for key, arr in out.items():
                store = self._store.get(key)
                if store is None:
                    store = self._store[key] = torch.empty(
                        (len(self._pos),) + tuple(arr.shape[1:]), dtype=arr.dtype,
                        pin_memory=pin)
                store[rows] = arr
            self.filled[rows.numpy()] = True
        if not self.filled.all():
            raise RuntimeError(f"teacher cache pre-pass left {int((~self.filled).sum())} "
                               "samples unfilled")

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._store.values())

    @property
    def on_device(self) -> bool:
        return self._dev is not None

    @property
    def device_nbytes(self) -> int:
        """Bytes held on the card by `to_device` (0 while on the host)."""
        if self._dev is None:
            return 0
        return sum(a.numel() * a.element_size() for a in self._dev.values())

    @property
    def device_has_images(self) -> bool:
        return self._dev is not None and "images" in self._dev

    def to_device(self, device, limit_bytes: int = 6 << 30) -> bool:
        """Move the store to `device` if it fits `limit_bytes`; else try
        again without the images and labels (whose host copies are then
        freed: the loader keeps its own); returns whether it moved. The
        host copies of what moved are freed."""
        if not self._store:
            return False
        keys = set(self._store)
        if self.nbytes > limit_bytes:
            keys -= {"images", "labels"}
            self._store.pop("images", None)
            self._store.pop("labels", None)
            total = sum(self._store[k].numel() * self._store[k].element_size() for k in keys)
            if not keys or total > limit_bytes:
                return False
        self._dev = {k: self._store.pop(k).to(device) for k in keys}
        return True

    def _rows(self, sel) -> torch.Tensor:
        rows = torch.as_tensor([self._pos[int(i)] for i in sel], dtype=torch.long)
        return rows.pin_memory() if torch.cuda.is_available() else rows

    def lookup(self, sel) -> Dict[str, torch.Tensor]:
        """The rows of dataset indices `sel`, host tensors."""
        rows = self._rows(sel)
        return {k: v.index_select(0, rows) for k, v in self._store.items()}

    def lookup_device(self, sel) -> Dict[str, torch.Tensor]:
        """The rows of dataset indices `sel`, gathered on the card: only the
        (len(sel),) index vector is copied, from pinned memory, without
        waiting for the card."""
        if self._dev is None:
            raise RuntimeError("the cache is on the host: call to_device first")
        dev = next(iter(self._dev.values())).device
        rows = self._rows(sel).to(dev, non_blocking=True)
        return {k: v.index_select(0, rows) for k, v in self._dev.items()}
