"""Dataset splits (a copy of `dense2sparse_vit_tpu/data/split.py`, numpy only).

  - split_train_val_indices: the in-memory 80/20 split of an ImageNet-val
    folder that the training loop trains and evaluates on;
  - split_imagenet_validation_set: the offline per-class train/val copy of a
    class-per-folder directory, a seeded shuffle per class.
"""

from __future__ import annotations

import os
import shutil
from typing import Tuple

import numpy as np


def split_train_val_indices(
    n: int, train_fraction: float = 0.8, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled index split (train, val) of range(n)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cut = int(n * train_fraction)
    return order[:cut], order[cut:]


def split_imagenet_validation_set(
    src_dir: str,
    dst_train: str,
    dst_val: str,
    val_fraction: float = 0.1,
    seed: int = 42,
    copy=shutil.copy2,
) -> Tuple[int, int]:
    """Copy class folders into train/val dirs with a seeded per-class split.

    Returns (n_train, n_val) file counts.
    """
    rng = np.random.default_rng(seed)
    n_train = n_val = 0
    for cls in sorted(os.listdir(src_dir)):
        cdir = os.path.join(src_dir, cls)
        if not os.path.isdir(cdir):
            continue
        files = sorted(os.listdir(cdir))
        rng.shuffle(files)
        cut = int(len(files) * val_fraction)
        val_files, train_files = files[:cut], files[cut:]
        for sub, names in ((dst_val, val_files), (dst_train, train_files)):
            out = os.path.join(sub, cls)
            os.makedirs(out, exist_ok=True)
            for f in names:
                copy(os.path.join(cdir, f), os.path.join(out, f))
        n_train += len(train_files)
        n_val += len(val_files)
    return n_train, n_val


def main():  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(
        description="Offline per-class train/val split of an ImageFolder dir"
    )
    p.add_argument("src_dir", help="source dir with one folder per class")
    p.add_argument("dst_train")
    p.add_argument("dst_val")
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()
    n_train, n_val = split_imagenet_validation_set(
        args.src_dir, args.dst_train, args.dst_val,
        val_fraction=args.val_fraction, seed=args.seed,
    )
    print(f"train: {n_train} files -> {args.dst_train}")
    print(f"val:   {n_val} files -> {args.dst_val}")


if __name__ == "__main__":  # pragma: no cover
    main()
