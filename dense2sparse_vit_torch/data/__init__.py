"""The data pipeline: class-folder datasets, host transforms, the batch
loader, the card-side finish (normalize, random erasing) and mixup/cutmix.

`Mixup` and `mixup_cutmix_batch` are loaded at their first use: the loader's
decode workers import this package, and nothing of it they run needs torch.
"""

from dense2sparse_vit_torch.data.pipeline import (
    ImageFolder,
    device_normalize,
    device_random_erasing,
    eval_transform,
    make_loader,
    train_transform,
)
from dense2sparse_vit_torch.data.split import split_imagenet_validation_set, split_train_val_indices

__all__ = [
    "ImageFolder", "Mixup", "device_normalize", "device_random_erasing", "eval_transform",
    "make_loader", "mixup_cutmix_batch", "split_imagenet_validation_set",
    "split_train_val_indices", "train_transform",
]


def __getattr__(name):
    if name in ("Mixup", "mixup_cutmix_batch"):
        from dense2sparse_vit_torch.data import mixup

        return getattr(mixup, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
