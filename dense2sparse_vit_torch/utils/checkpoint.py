"""Checkpoints: save, restore and resume on `torch.save` (port of
`dense2sparse_vit_tpu/utils/checkpoint.py`).

Two streams under one directory, as the JAX package keeps them:

  <dir>/best/   saves whose validation metric improved (the deployable
                checkpoint), the last `max_to_keep` (3) of them;
  <dir>/latest/ a save every epoch, the last 2, so that --resume continues
                from the last epoch even where the metric has plateaued.

A checkpoint is `step_<n>.pt` (the state, written to a temporary file and
renamed, so a crash leaves no half file) beside `step_<n>.json` (its
metrics). Resume restores the highest step across both streams; the best
stream's metric is read back on opening, so a resumed run never replaces
its best checkpoint with a worse one. What a checkpoint holds is the
caller's: the training loop saves the student's state_dict, the optimizer's
(with its update count and a mid-cycle accumulator) and the micro-step
counter.

Under a process group every rank calls `save` / `save_if_best` and tracks
the best metric, rank 0 alone writes, and every rank waits for the write
(a barrier). A tensor-parallel student's state is gathered into the full
tensors before the save (`save_tensor_parallel`) and split again on the
restore (`restore_tensor_parallel`), bit for bit.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import torch

from dense2sparse_vit_torch.core.mesh import barrier, is_primary

_STEP = re.compile(r"^step_(\d+)\.pt$")


class _Stream:
    def __init__(self, directory: str, max_to_keep: int):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"step_{step}.{ext}")

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(state, tmp)
        with open(self.path(step, "json"), "w") as f:
            json.dump(metrics or {}, f)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            for ext in ("pt", "json"):
                if os.path.exists(self.path(old, ext)):
                    os.remove(self.path(old, ext))

    def metrics(self, step: int) -> dict:
        try:
            with open(self.path(step, "json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def restore(self, step: int, map_location=None) -> Any:
        return torch.load(self.path(step), map_location=map_location, weights_only=False)


class CheckpointManager:
    """The best and latest streams over one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._best = _Stream(os.path.join(self.directory, "best"), max_to_keep)
        self._latest = _Stream(os.path.join(self.directory, "latest"), 2)
        # the historical best survives a re-open
        self.best_metric: Optional[float] = None
        bs = self._best.latest_step()
        if bs is not None and self._best.metrics(bs).get("best_metric") is not None:
            self.best_metric = float(self._best.metrics(bs)["best_metric"])

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        """Save into the latest stream (every epoch); a step already there
        (an epoch that made no train step) is not saved again. Rank 0
        writes; every rank waits."""
        if is_primary() and step not in self._latest.all_steps():
            self._latest.save(step, state, metrics)
        barrier()

    def save_if_best(self, step: int, state: Any, metric: float) -> bool:
        """Save into the best stream when `metric` beats the best so far
        (higher is better); returns whether it saved. Rank 0 writes; every
        rank tracks the best and waits."""
        better = self.best_metric is None or metric > self.best_metric
        if better:
            self.best_metric = metric
            if is_primary():
                self._best.save(step, state, {"best_metric": metric})
        barrier()
        return better

    def latest_step(self) -> Optional[int]:
        """The highest step across both streams (what --resume restores)."""
        return max((s for s in (self._best.latest_step(), self._latest.latest_step())
                    if s is not None), default=None)

    def best_step(self) -> Optional[int]:
        return self._best.latest_step()

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The saved state at `step`, by default the highest across both
        streams (the latest stream's copy where both hold it)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        stream = self._latest if step in self._latest.all_steps() else self._best
        return stream.restore(step, map_location)

    def restore_best(self, map_location=None) -> Any:
        step = self.best_step()
        if step is None:
            raise FileNotFoundError(f"no best-stream checkpoints under {self.directory}")
        return self._best.restore(step, map_location)

    def close(self) -> None:
        """Nothing is left open between calls; kept for the JAX manager's
        interface."""


def save_tensor_parallel(ckpt: CheckpointManager, step: int, local_state: dict, mesh,
                         extra: Optional[dict] = None) -> None:
    """Save a tensor-parallel student: its shards gathered over the model
    group into the full state_dict (every rank calls this), written by rank
    0 as {"student": full, **extra}."""
    from dense2sparse_vit_torch.parallel.tensor_parallel import gather_params

    full = {k: v.detach().cpu() for k, v in gather_params(local_state, mesh).items()}
    ckpt.save(step, {"student": full, **(extra or {})})


def restore_tensor_parallel(ckpt: CheckpointManager, mesh, step: Optional[int] = None) -> dict:
    """This rank's shards of a saved full student state_dict (every rank
    reads the file), split as `parallel.tensor_parallel.shard_params`
    splits, bit for bit."""
    from dense2sparse_vit_torch.parallel.tensor_parallel import shard_params

    return shard_params(ckpt.restore(step, map_location="cpu")["student"], mesh)
