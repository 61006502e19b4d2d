"""Training-time augmentations: RandAugment (rand-m9-mstd0.5-inc1) and
pixel-mode random erasing (a copy of `dense2sparse_vit_tpu/data/augment.py`,
PIL + numpy).

timm's `create_transform` parity: RandomResizedCrop + flip + RandAugment
with the 'increasing' op set, magnitude 9, magnitude-std 0.5, 2 layers, then
normalize + RandomErasing(p=0.25, mode='pixel', count=1). timm ignores the
color-jitter argument whenever an auto-augment policy is set. Every random
draw comes from the numpy Generator the caller passes.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_MAX_LEVEL = 10.0
# timm create_transform passes aa_params img_mean = round(255 * mean) as
# the geometric-op fill color (timm/data/transforms_factory.py); for the
# ImageNet mean that is (124, 116, 104), NOT the bare-timm default 128
_FILL = (124, 116, 104)


def _randomly_negate(v, rng):
    return -v if rng.random() < 0.5 else v


# --- op implementations (PIL) -------------------------------------------------

def _shear_x(img, v, fill):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                         resample=Image.BICUBIC, fillcolor=fill)


def _shear_y(img, v, fill):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                         resample=Image.BICUBIC, fillcolor=fill)


def _translate_x_rel(img, v, fill):
    pixels = v * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         resample=Image.BICUBIC, fillcolor=fill)


def _translate_y_rel(img, v, fill):
    pixels = v * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         resample=Image.BICUBIC, fillcolor=fill)


def _rotate(img, v, fill):
    return img.rotate(v, resample=Image.BICUBIC, fillcolor=fill)


def _posterize(img, bits):
    return ImageOps.posterize(img, max(1, int(bits)))


def _solarize(img, thresh):
    return ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    arr = np.asarray(img).astype(np.int64)
    arr = np.where(arr < thresh, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


# (name, level_fn, apply_fn); level_fn maps magnitude -> op argument
def _enh(factory):
    return lambda img, v: factory(img).enhance(v)


def _ops(rng, fill=_FILL):
    def signed(scale):
        return lambda m: _randomly_negate(m / _MAX_LEVEL * scale, rng)

    def enhance_inc():
        # 'increasing' enhancement: factor 1 +/- 0.9 * m/10
        return lambda m: 1.0 + _randomly_negate(m / _MAX_LEVEL * 0.9, rng)

    def geo(fn):
        return lambda img, v: fn(img, v, fill)

    return [
        ("AutoContrast", None, lambda img, v: ImageOps.autocontrast(img)),
        ("Equalize", None, lambda img, v: ImageOps.equalize(img)),
        ("Invert", None, lambda img, v: ImageOps.invert(img)),
        ("Rotate", signed(30.0), geo(_rotate)),
        ("Posterize", lambda m: 4 - int(m / _MAX_LEVEL * 4), _posterize),
        ("Solarize", lambda m: 256 - int(m / _MAX_LEVEL * 256), _solarize),
        ("SolarizeAdd", lambda m: int(m / _MAX_LEVEL * 110), _solarize_add),
        ("Color", enhance_inc(), _enh(ImageEnhance.Color)),
        ("Contrast", enhance_inc(), _enh(ImageEnhance.Contrast)),
        ("Brightness", enhance_inc(), _enh(ImageEnhance.Brightness)),
        ("Sharpness", enhance_inc(), _enh(ImageEnhance.Sharpness)),
        ("ShearX", signed(0.3), geo(_shear_x)),
        ("ShearY", signed(0.3), geo(_shear_y)),
        ("TranslateXRel", signed(0.45), geo(_translate_x_rel)),
        ("TranslateYRel", signed(0.45), geo(_translate_y_rel)),
    ]


class RandAugment:
    """rand-mN-mstdS-inc1 policy (the timm policy string)."""

    def __init__(self, magnitude=9, magnitude_std=0.5, num_layers=2,
                 prob=0.5, fill=_FILL):
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.num_layers = num_layers
        self.prob = prob
        self.fill = fill

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        ops = _ops(rng, self.fill)
        for _ in range(self.num_layers):
            if rng.random() > self.prob:
                continue
            name, level_fn, fn = ops[rng.integers(len(ops))]
            m = self.magnitude
            if self.magnitude_std > 0:
                m = rng.normal(m, self.magnitude_std)
            m = float(np.clip(m, 0, _MAX_LEVEL))
            v = level_fn(m) if level_fn is not None else None
            img = fn(img, v)
        return img


def parse_rand_augment(spec: str, fill=None) -> RandAugment:
    """Parse a timm-style policy string, e.g. 'rand-m9-mstd0.5-inc1'.

    fill: geometric-op fill color; timm's create_transform derives it from
    the dataset mean (round(255*mean)), see _FILL above.
    """
    if not spec.startswith("rand"):
        raise ValueError(f"only 'rand-*' policies supported, got {spec!r}")
    kwargs = {} if fill is None else {"fill": tuple(fill)}
    for part in spec.split("-")[1:]:
        if part.startswith("mstd"):
            kwargs["magnitude_std"] = float(part[4:])
        elif part.startswith("m"):
            kwargs["magnitude"] = int(part[1:])
        elif part.startswith("n"):
            kwargs["num_layers"] = int(part[1:])
        elif part.startswith("inc"):
            pass  # the op table above is already the 'increasing' set
        elif part.startswith("p"):
            kwargs["prob"] = float(part[1:])
    return RandAugment(**kwargs)


def random_erasing(
    x: np.ndarray,
    rng: np.random.Generator,
    prob: float = 0.25,
    count: int = 1,
    area_range=(0.02, 1 / 3),
    aspect_range=(0.3, 10 / 3),
) -> np.ndarray:
    """timm RandomErasing, mode='pixel': fill the erased box with unit
    normal noise, applied after normalization.

    x: (H, W, C) float array (normalized). Mutates and returns x.
    """
    if rng.random() > prob:
        return x
    H, W, C = x.shape
    area = H * W
    for _ in range(count):
        for _attempt in range(10):
            target = rng.uniform(*area_range) * area
            aspect = np.exp(rng.uniform(np.log(aspect_range[0]), np.log(aspect_range[1])))
            h = int(round(np.sqrt(target * aspect)))
            w = int(round(np.sqrt(target / aspect)))
            if h < H and w < W:
                top = rng.integers(0, H - h + 1)
                left = rng.integers(0, W - w + 1)
                x[top:top + h, left:left + w] = rng.normal(size=(h, w, C))
                break
    return x
