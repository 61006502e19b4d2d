"""Metrics logging: stdout, `metrics.jsonl`, and TensorBoard and wandb
where they import (port of `dense2sparse_vit_tpu/utils/logging.py`; one
process, so every sink is the primary's)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, workdir: str, job_name: str = "run", use_tensorboard: bool = False,
                 use_wandb: bool = False, wandb_config: Optional[dict] = None):
        self.workdir = workdir
        self.job_name = job_name
        self._tb = None
        self._wandb = None
        os.makedirs(workdir, exist_ok=True)
        self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
            except Exception as e:  # the tensorboard package is optional
                print(f"tensorboard unavailable ({e}); skipping")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="dense2sparse-vit-torch", name=job_name,
                           config=wandb_config or {})
            except Exception as e:  # wandb is optional
                print(f"wandb unavailable ({e}); skipping")

    def log(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        flat = {(f"{prefix}/{k}" if prefix else k): float(v) for k, v in metrics.items()}
        record = {"step": step, "time": time.time(), **flat}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(flat, step=step)
        line = " ".join(f"{k}={v:.4f}" for k, v in flat.items())
        print(f"[{self.job_name} step {step}] {line}", flush=True)

    def summary(self, metrics: Dict[str, float]):
        if self._wandb is not None:
            for k, v in metrics.items():
                self._wandb.run.summary[k] = v
        with open(os.path.join(self.workdir, "summary.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def slurm_job_name(cfg) -> str:
    """A job name from the key hyperparameters (and $SLURM_JOB_ID where set)."""
    pr = cfg.pruning
    parts = [
        cfg.arch,
        f"L{'-'.join(map(str, pr.pruning_locs))}",
        f"K{'-'.join(f'{r:g}' for r in pr.keep_ratios)}",
        pr.selection,
        pr.mask_loss_type,
    ]
    if pr.patch_score_threshold is not None:
        parts.append(f"th{pr.patch_score_threshold:g}")
    if pr.small_predictor:
        parts.append("sMP")
    if pr.predictor_bn:
        parts.append("bn")
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id:
        parts.append(job_id)
    return "_".join(parts)
