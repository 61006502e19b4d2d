"""ImageNet-style data pipeline: host-side NHWC numpy batches, finished on
the card (a port of `dense2sparse_vit_tpu/data/pipeline.py`).

An index over class folders, per-sample PIL decode and transform, and a
batch iterator with a prefetch thread. Eval transform: Resize(256, bicubic)
-> CenterCrop(224) -> Normalize. Train transform: RandomResizedCrop(224,
bicubic) -> flip -> RandAugment -> Normalize -> RandomErasing, as timm's
`create_transform` builds it. The training loop stops the host transform
after RandAugment (uint8) and runs Normalize and RandomErasing on the card
(`device_normalize`, `device_random_erasing`).

Randomness. The train transform takes its numpy Generator per call, and the
loader gives sample i of epoch e the generator `np.random.default_rng([seed,
e, i])`, so a sample's crop, flip and RandAugment draws depend on neither
the worker that decodes it nor on where a run was resumed. The loader's
shuffle is seeded with seed + epoch, the epoch being the caller's (the loop
passes it), which for an uninterrupted run is the JAX loader's order. The
card-side random functions are split into draws (`erasing_draws`, sampled
from a `torch.Generator`) and a pure function of the draws
(`erase_with_draws`).

Workers. With num_workers > 0 the loader decodes in a process pool of the
`spawn` start method (`concurrent.futures.ProcessPoolExecutor`), created at
the first epoch that decodes (never at import, never by a loader whose
batches all come from its decoded cache), and the dataset is sent to each
worker once, at its start. A spawned worker starts from a fresh
interpreter, so no worker inherits the parent's CUDA context, whenever the
parent made it; a worker that dies raises BrokenProcessPool in the
consumer instead of leaving it waiting. Spawning imports the parent's main
module in each worker, so a script that builds a loader with workers keeps
its work under `if __name__ == "__main__":`. The pool is stopped by the
loader's `close()` and at exit.
"""

from __future__ import annotations

import atexit
import collections
import itertools
import math
import os
import queue as queue_mod
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from dense2sparse_vit_torch.core.config import DataConfig
from dense2sparse_vit_torch.data.augment import parse_rand_augment, random_erasing

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class _FeederError:
    """Exception carrier from the prefetch thread to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class ImageFolder:
    """Directory-per-class dataset index (torchvision ImageFolder's order:
    classes sorted, files sorted within a class). `load(i, rng)` decodes
    sample i and applies the transform, passing `rng` to a random one."""

    def __init__(self, root: str, transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append(
                        (os.path.join(cdir, fname), self.class_to_idx[c])
                    )

    def __len__(self):
        return len(self.samples)

    def load(self, i: int, rng: Optional[np.random.Generator] = None):
        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img = self.transform(img, rng) if is_random(self.transform) else self.transform(img)
        return img, label

    def __getitem__(self, i: int):
        return self.load(i)


def is_random(transform) -> bool:
    """True for a transform that takes a numpy Generator per call."""
    return bool(getattr(transform, "random", False))


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """The generator of dataset sample `index` in `epoch`."""
    return np.random.default_rng([seed, epoch, int(index)])


def _normalize(arr: np.ndarray, cfg: DataConfig) -> np.ndarray:
    """uint8 or float HWC (or NHWC) -> (x / 255 - mean) / std, float32;
    uint8 through the native one-pass kernel (`native.normalize_u8`)."""
    if arr.dtype == np.uint8:
        from dense2sparse_vit_torch.native import normalize_u8

        return normalize_u8(arr, cfg.mean, cfg.std)
    arr = arr.astype(np.float32) / 255.0
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    return (arr - mean) / std


_NORM_CONSTANTS: dict = {}


def device_normalize(x, cfg: DataConfig):
    """uint8 (or float) NHWC -> normalized float32 on x's device, as the
    JAX package's: (x - 255 mean) * 1 / (255 std) in fp32. The constants are
    made on a device once and kept, so a call never waits for the card."""
    import torch

    key = (x.device, tuple(cfg.mean), tuple(cfg.std))
    if key not in _NORM_CONSTANTS:
        mean = torch.tensor(cfg.mean, dtype=torch.float32) * 255.0
        inv = 1.0 / (torch.tensor(cfg.std, dtype=torch.float32) * 255.0)
        # made by fill kernels on the device: a copy from the host would
        # wait for the card
        _NORM_CONSTANTS[key] = tuple(
            torch.stack([torch.full((), e, dtype=torch.float32, device=x.device)
                         for e in v.tolist()]) for v in (mean, inv))
    mean, inv = _NORM_CONSTANTS[key]
    return (x.to(torch.float32) - mean) * inv


class EvalTransform:
    """Resize(short side = eval_resize, bicubic) -> CenterCrop(eval_crop)
    -> Normalize; with normalize=False it returns the uint8 HWC crop."""

    random = False

    def __init__(self, cfg: DataConfig, normalize: bool = True):
        self.cfg = cfg
        self.normalize = normalize

    def __call__(self, img: Image.Image) -> np.ndarray:
        # torchvision's resize: short side = size, long side truncated
        # (int, not round); a no-op where the short side is already size
        w, h = img.size
        size = self.cfg.eval_resize
        if not ((w <= h and w == size) or (h <= w and h == size)):
            if w < h:
                ow, oh = size, int(size * h / w)
            else:
                oh, ow = size, int(size * w / h)
            img = img.resize((ow, oh), Image.BICUBIC)
        # torchvision's center crop: offsets int(round((full - crop) / 2))
        w, h = img.size
        c = self.cfg.eval_crop
        left = int(round((w - c) / 2.0))
        top = int(round((h - c) / 2.0))
        img = img.crop((left, top, left + c, top + c))
        arr = np.asarray(img)
        return _normalize(arr, self.cfg) if self.normalize else arr


def eval_transform(cfg: DataConfig, normalize: bool = True) -> EvalTransform:
    return EvalTransform(cfg, normalize)


class TrainTransform:
    """RandomResizedCrop -> flip -> RandAugment -> Normalize ->
    RandomErasing, every draw from the `rng` of the call. as_uint8: stop
    after RandAugment and return the uint8 array (the loop finishes on the
    card)."""

    random = True

    def __init__(self, cfg: DataConfig, as_uint8: bool = False):
        if cfg.train_interpolation not in ("bicubic", "bilinear"):
            raise ValueError(f"unknown interpolation {cfg.train_interpolation!r}")
        self.cfg = cfg
        self.as_uint8 = as_uint8
        # geometric-op fill = round(255 * mean), as timm's create_transform
        fill = tuple(min(255, round(255 * m)) for m in cfg.mean)
        self.ra = parse_rand_augment(cfg.auto_augment, fill=fill) if cfg.auto_augment else None

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        interp = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[cfg.train_interpolation]
        # RandomResizedCrop(scale=(0.08, 1.0), ratio=(3/4, 4/3))
        w, h = img.size
        area = w * h
        for _ in range(10):
            target = rng.uniform(0.08, 1.0) * area
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                left = rng.integers(0, w - cw + 1)
                top = rng.integers(0, h - ch + 1)
                img = img.crop((left, top, left + cw, top + ch))
                break
        else:  # center fallback
            s = min(w, h)
            img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        img = img.resize((cfg.eval_crop, cfg.eval_crop), interp)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.ra is not None:
            img = self.ra(img, rng)
        if self.as_uint8:
            return np.asarray(img, dtype=np.uint8)
        arr = _normalize(np.asarray(img), cfg)
        if cfg.reprob > 0:
            arr = random_erasing(arr, rng, prob=cfg.reprob, count=cfg.recount)
        return arr


def train_transform(cfg: DataConfig, as_uint8: bool = False) -> TrainTransform:
    return TrainTransform(cfg, as_uint8)


# ---- random erasing on the card ---------------------------------------------

ERASE_ATTEMPTS = 10
ERASE_AREA = (0.02, 1.0 / 3.0)
ERASE_LOG_ASPECT = (math.log(0.3), math.log(10.0 / 3.0))


def erasing_draws(generator, shape, cfg: DataConfig, dtype=None):
    """The random draws of `device_random_erasing` over a (B, H, W, C) batch,
    on the generator's device: a per-sample gate uniform, then per box
    (cfg.recount of them) ERASE_ATTEMPTS area fractions in ERASE_AREA and
    log aspects in ERASE_LOG_ASPECT per sample, the top and left uniforms
    and the fill noise. None where erasing is off."""
    import torch

    if cfg.reprob <= 0.0 or cfg.recount <= 0:
        return None
    B = shape[0]
    dev = generator.device
    kw = dict(generator=generator, device=dev)

    def uniform(size, lo, hi):
        return torch.rand(size, **kw) * (hi - lo) + lo

    gate = torch.rand((B,), **kw)
    boxes = [{
        "target": uniform((B, ERASE_ATTEMPTS), *ERASE_AREA),
        "log_aspect": uniform((B, ERASE_ATTEMPTS), *ERASE_LOG_ASPECT),
        "top": torch.rand((B,), **kw),
        "left": torch.rand((B,), **kw),
        "noise": torch.randn(tuple(shape), dtype=dtype or torch.float32, **kw),
    } for _ in range(cfg.recount)]
    return {"gate": gate, "boxes": boxes}


def erase_with_draws(x, draws, prob: float):
    """timm's RandomErasing (mode 'pixel') over a normalized (B, H, W, C)
    batch, from `erasing_draws`: one gate per sample (uniform <= prob),
    then per box the first of the attempts whose rounded h, w fit (none:
    no box), placed at floor(u * (H - h + 1)), floor(u * (W - w + 1)) and
    filled with the noise. All on the card, no host sync."""
    import torch

    if draws is None:
        return x
    B, H, W, _ = x.shape
    area = float(H * W)
    apply = draws["gate"] <= prob
    rows = torch.arange(H, device=x.device)[None, :]
    cols = torch.arange(W, device=x.device)[None, :]
    for d in draws["boxes"]:
        target = d["target"] * area
        aspect = torch.exp(d["log_aspect"])
        h = torch.round(torch.sqrt(target * aspect)).to(torch.int32)
        w = torch.round(torch.sqrt(target / aspect)).to(torch.int32)
        valid = (h < H) & (w < W)
        pick = valid.to(torch.int32).argmax(dim=1, keepdim=True)  # the first valid attempt
        any_valid = valid.any(dim=1)
        h = torch.gather(h, 1, pick)[:, 0]
        w = torch.gather(w, 1, pick)[:, 0]
        top = torch.floor(d["top"] * (H - h + 1).to(torch.float32)).to(torch.int32)
        left = torch.floor(d["left"] * (W - w + 1).to(torch.float32)).to(torch.int32)
        rmask = (rows >= top[:, None]) & (rows < (top + h)[:, None])
        cmask = (cols >= left[:, None]) & (cols < (left + w)[:, None])
        mask = rmask[:, :, None] & cmask[:, None, :] & (apply & any_valid)[:, None, None]
        x = torch.where(mask[..., None], d["noise"].to(x.dtype), x)
    return x


def device_random_erasing(x, cfg: DataConfig, generator):
    """timm's RandomErasing (mode 'pixel') on the card over a normalized
    (B, H, W, C) batch, its draws from `generator`."""
    return erase_with_draws(x, erasing_draws(generator, x.shape, cfg, x.dtype), cfg.reprob)


# ---- the loader -------------------------------------------------------------

# the dataset a pool worker decodes from, set once by the pool's initializer
_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load_batch(sel, seed: int, epoch: int, dataset=None):
    dataset = _WORKER_DATASET if dataset is None else dataset
    rand = is_random(dataset.transform)
    imgs, labels = [], []
    for i in sel:
        x, y = dataset.load(int(i), sample_rng(seed, epoch, i) if rand else None)
        imgs.append(x)
        labels.append(y)
    return np.stack(imgs), np.asarray(labels, np.int32)


def make_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
    indices: Optional[Sequence[int]] = None,
    prefetch: int = 2,
    num_workers: int = 0,
    normalize_cfg: Optional[DataConfig] = None,
    cache_decoded: bool = False,
    with_indices: bool = False,
    as_uint8: bool = False,
    shared_cache: Optional[dict] = None,
    pin_memory: bool = False,
) -> Callable[..., Iterator[tuple]]:
    """Batch iterator factory with parallel decode and prefetch.

    Returns `epoch_iter(epoch=None)`, a fresh iterator over one epoch's
    batches; without `epoch` it counts the epochs it has been called for,
    as the JAX loader does. `indices`: subset sampling (the 80/20 split).
    It has a `close()` that stops the worker pool.

    Args:
      shuffle: the order of `indices` shuffled by default_rng(seed + epoch).
      num_workers: > 0 decodes in that many spawned processes (module
        docstring), one batch a task, at most num_workers + prefetch
        batches ahead; the batches are those of num_workers=0.
      normalize_cfg: normalize uint8 batches on the host (float32 output).
      cache_decoded: keep decoded uint8 samples in one host array, so epochs
        after the first skip the decode; needs a deterministic uint8
        transform (eval_transform(cfg, normalize=False)).
      with_indices: yield (batch, labels, dataset_indices): the key the
        teacher cache looks rows up by.
      as_uint8: yield raw uint8 batches (needs a uint8 transform).
      shared_cache: one dict passed to several loaders over the same
        indices shares their decoded store.
      pin_memory: yield torch tensors, in pinned host memory where a CUDA
        device is present (made in the prefetch thread), for copies to the
        card with non_blocking=True.
    """
    idx = np.asarray(indices if indices is not None else np.arange(len(dataset)))
    rand = is_random(dataset.transform)

    def probe():
        return np.asarray(dataset.load(int(idx[0]), sample_rng(seed, 0, idx[0]) if rand else None)[0])

    if as_uint8 and probe().dtype != np.uint8:
        # checked here, not in the feeder thread, where a raise would come
        # only at the first batch
        raise ValueError("as_uint8 requires a uint8 transform "
                         "(eval_transform(cfg, normalize=False))")

    cache: dict = shared_cache if shared_cache is not None else {}
    if cache_decoded and "store" not in cache:
        if rand:
            raise ValueError("cache_decoded requires a deterministic transform: a random "
                             "one is drawn anew every epoch")
        first = probe()
        if first.dtype != np.uint8:
            raise ValueError("cache_decoded requires a uint8 transform "
                             "(eval_transform(cfg, normalize=False))")
        # sized by this loader's index subset, remapped through a
        # dataset-index -> row dict
        cache["pos"] = {int(i): r for r, i in enumerate(idx)}
        cache["store"] = np.empty((len(idx),) + first.shape, np.uint8)
        cache["filled"] = np.zeros(len(idx), bool)
        cache["labels"] = np.empty(len(idx), np.int32)

    pool_holder: list = []

    def pool():
        if not pool_holder:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            p = ProcessPoolExecutor(num_workers, mp_context=mp.get_context("spawn"),
                                    initializer=_pool_init, initargs=(dataset,))
            atexit.register(p.shutdown, wait=False, cancel_futures=True)
            pool_holder.append(p)
        return pool_holder[0]

    def finalize(batch, labels, sel):
        if as_uint8:
            if batch.dtype != np.uint8:
                raise ValueError("as_uint8 requires a uint8 transform")
        else:
            if normalize_cfg is not None and batch.dtype == np.uint8:
                batch = _normalize(batch, normalize_cfg)
            batch = batch.astype(np.float32, copy=False)
        if pin_memory:
            import torch

            batch = torch.from_numpy(np.ascontiguousarray(batch))
            labels = torch.from_numpy(labels)
            if torch.cuda.is_available():
                batch, labels = batch.pin_memory(), labels.pin_memory()
        return (batch, labels, sel) if with_indices else (batch, labels)

    def load_cached(sel):
        store, filled, lab, pos = cache["store"], cache["filled"], cache["labels"], cache["pos"]
        rows = [pos[int(i)] for i in sel]
        for i, r in zip(sel, rows):
            if not filled[r]:
                x, y = dataset.load(int(i))
                store[r], lab[r], filled[r] = x, y, True
        return store[rows], lab[rows]

    def epoch_iter(epoch: Optional[int] = None):
        if epoch is None:
            epoch = epoch_iter.count
        epoch_iter.count = epoch + 1
        order = idx.copy()
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        n_batches = len(order) // batch_size if drop_last else -(-len(order) // batch_size)
        sels = [order[b * batch_size:(b + 1) * batch_size] for b in range(n_batches)]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def batches():
            if cache_decoded:
                for sel in sels:
                    yield sel, load_cached(sel)
            elif num_workers > 0:
                # bounded look-ahead in batch order: an epoch the consumer
                # leaves early does not go on decoding in the pool
                p = pool()
                todo = iter(sels)
                pending = collections.deque(
                    (sel, p.submit(_load_batch, sel, seed, epoch))
                    for sel in itertools.islice(todo, num_workers + prefetch))
                while pending:
                    sel, res = pending.popleft()
                    nxt = next(todo, None)
                    if nxt is not None:
                        pending.append((nxt, p.submit(_load_batch, nxt, seed, epoch)))
                    yield sel, res.result()
            else:
                for sel in sels:
                    yield sel, _load_batch(sel, seed, epoch, dataset)

        def feeder():
            # every exception reaches the consumer, which would otherwise
            # wait on the queue forever
            try:
                for sel, (batch, labels) in batches():
                    if stop.is_set() or not put(finalize(batch, labels, sel)):
                        return
            except BaseException as exc:  # noqa: BLE001
                put(_FeederError(exc))
                return
            put(None)

        threading.Thread(target=feeder, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _FeederError):
                    raise item.exc
                yield item
        finally:
            stop.set()

    def close():
        for p in pool_holder:
            p.shutdown(wait=True, cancel_futures=True)
        pool_holder.clear()

    epoch_iter.count = 0
    epoch_iter.close = close
    return epoch_iter
