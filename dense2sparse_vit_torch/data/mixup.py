"""Mixup / CutMix with soft targets, in torch on the batch's device (a port
of `dense2sparse_vit_tpu/data/mixup.py`).

timm's `Mixup`: batch, elem and pair modes, the mixup/cutmix switch
probability, cutmix_minmax boxes, application probability `prob`, the
lambda corrected from the box's area, and label smoothing folded into the
one-hot targets. Each batch is mixed with its flipped copy. The random
draws (`mixup_draws`, from a `torch.Generator`) are split from the mix
(`mix_with_draws`, a pure function of them), and both branches are
computed and selected with `torch.where`, so a call never waits for the
card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MODES = ("batch", "elem", "pair")


def _one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.float32)
    return one_hot * (on - off) + off


def _beta(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Beta(alpha, alpha) samples as X / (X + Y), X, Y ~ Gamma(alpha)."""
    conc = torch.full((2,) + tuple(shape), float(alpha), device=generator.device)
    g = torch._standard_gamma(conc, generator=generator)
    return g[0] / (g[0] + g[1])


def mixup_draws(generator: torch.Generator, batch: int, height: int, width: int,
                mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                cutmix_minmax: Optional[Tuple[float, float]] = None,
                mode: str = "batch") -> dict:
    """The random draws of one mix, on the generator's device; each has the
    shape () in batch mode and (B,) otherwise:
      apply_u, switch_u: uniforms (the `prob` and `switch_prob` tests);
      lam_m, lam_c: Beta(alpha, alpha) of mixup and cutmix (ones where an
        alpha is 0);
      the box: cy, cx (centres in [0, H) and [0, W)), or with cutmix_minmax
        cut_h, cut_w (sides in [H mn, H mx] and [W mn, W mx]) and the
        offset uniforms uy, ux.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mixup mode {mode!r}")
    per = () if mode == "batch" else (batch,)
    kw = dict(generator=generator, device=generator.device)
    ones = torch.ones(per, device=generator.device)
    d = {
        "apply_u": torch.rand(per, **kw),
        "switch_u": torch.rand(per, **kw),
        "lam_m": _beta(generator, mixup_alpha, per) if mixup_alpha > 0 else ones,
        "lam_c": _beta(generator, cutmix_alpha, per) if cutmix_alpha > 0 else ones,
    }
    if cutmix_minmax is not None:
        mn, mx = cutmix_minmax
        d["cut_h"] = torch.randint(int(height * mn), int(height * mx) + 1, per, **kw)
        d["cut_w"] = torch.randint(int(width * mn), int(width * mx) + 1, per, **kw)
        d["uy"] = torch.rand(per, **kw)
        d["ux"] = torch.rand(per, **kw)
    else:
        d["cy"] = torch.randint(0, height, per, **kw)
        d["cx"] = torch.randint(0, width, per, **kw)
    return d


def mix_with_draws(images: torch.Tensor, labels: torch.Tensor, draws: dict, num_classes: int,
                   mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                   cutmix_minmax: Optional[Tuple[float, float]] = None, prob: float = 1.0,
                   switch_prob: float = 0.5, smoothing: float = 0.1,
                   mode: str = "batch") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixup or cutmix of (B, H, W, C) `images` against the flipped batch,
    from `mixup_draws`: (mixed images in images' dtype, (B, num_classes)
    fp32 soft targets).

      batch: one lam and one mixup/cutmix decision for the whole batch;
      elem: a lam and a decision per sample;
      pair: per sample, sample i and B-1-i sharing theirs (the draws at
        min(i, B-1-i)), the box centres still per sample.
    With one of the two alphas 0 (and no cutmix_minmax for cutmix) that one
    is never chosen; cutmix's lam is 1 - box area / (H W).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mixup mode {mode!r}")
    B, H, W, _ = images.shape
    dev = images.device
    apply = draws["apply_u"] < prob
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = draws["switch_u"] < switch_prob
    else:  # one augmentation enabled: always that one
        use_cutmix = torch.full_like(apply, cutmix_alpha > 0 or cutmix_minmax is not None)
    lam_m, lam_c = draws["lam_m"], draws["lam_c"]
    if mode == "pair":
        i = torch.arange(B, device=dev)
        pair = torch.minimum(i, B - 1 - i)
        apply, use_cutmix, lam_m, lam_c = (v[pair] for v in (apply, use_cutmix, lam_m, lam_c))

    flipped = images.flip(0)
    bshape = () if mode == "batch" else (B, 1, 1, 1)

    # mixup
    lam_m = torch.where(apply, lam_m, torch.ones_like(lam_m))
    lm = lam_m.reshape(bshape)
    mixed_m = images * lm + flipped * (1.0 - lm)

    # cutmix: the flipped batch's box pasted in
    if cutmix_minmax is not None:
        cut_h, cut_w = draws["cut_h"].to(torch.int32), draws["cut_w"].to(torch.int32)
        y1 = (draws["uy"] * (H - cut_h + 1).to(torch.float32)).to(torch.int32)
        x1 = (draws["ux"] * (W - cut_w + 1).to(torch.float32)).to(torch.int32)
        y2, x2 = y1 + cut_h, x1 + cut_w
    else:
        ratio = torch.sqrt(1.0 - lam_c)
        cut_h = (H * ratio).to(torch.int32)
        cut_w = (W * ratio).to(torch.int32)
        cy, cx = draws["cy"].to(torch.int32), draws["cx"].to(torch.int32)
        y1 = torch.clamp(cy - torch.div(cut_h, 2, rounding_mode="floor"), 0, H)
        y2 = torch.clamp(cy + torch.div(cut_h, 2, rounding_mode="floor"), 0, H)
        x1 = torch.clamp(cx - torch.div(cut_w, 2, rounding_mode="floor"), 0, W)
        x2 = torch.clamp(cx + torch.div(cut_w, 2, rounding_mode="floor"), 0, W)
    yy = torch.arange(H, device=dev)[None, :, None, None]
    xx = torch.arange(W, device=dev)[None, None, :, None]
    b = [v.reshape(bshape if mode != "batch" else ()) for v in (y1, y2, x1, x2)]
    in_box = (yy >= b[0]) & (yy < b[1]) & (xx >= b[2]) & (xx < b[3])
    mixed_c = torch.where(in_box & apply.reshape(bshape), flipped, images)
    # lambda from the box's actual area
    area = ((y2 - y1) * (x2 - x1)).reshape(apply.shape)
    lam_c_eff = torch.where(apply, 1.0 - area.to(torch.float32) / (H * W),
                            torch.ones_like(lam_m))

    out = torch.where(use_cutmix.reshape(bshape), mixed_c, mixed_m)
    lam = torch.where(use_cutmix, lam_c_eff, lam_m).to(torch.float32)
    if mode != "batch":
        lam = lam[:, None]
    t1 = _one_hot_smooth(labels, num_classes, smoothing)
    t2 = _one_hot_smooth(labels.flip(0), num_classes, smoothing)
    return out.to(images.dtype), t1 * lam + t2 * (1.0 - lam)


def mixup_cutmix_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                       cutmix_minmax: Optional[Tuple[float, float]] = None, prob: float = 1.0,
                       switch_prob: float = 0.5, smoothing: float = 0.1,
                       mode: str = "batch") -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw from `generator` and mix: (mixed images, soft targets)."""
    B, H, W, _ = images.shape
    draws = mixup_draws(generator, B, H, W, mixup_alpha, cutmix_alpha, cutmix_minmax, mode)
    return mix_with_draws(images, labels, draws, num_classes, mixup_alpha, cutmix_alpha,
                          cutmix_minmax, prob, switch_prob, smoothing, mode)


class Mixup:
    """Config-bound wrapper with timm's Mixup constructor surface."""

    def __init__(self, mixup_alpha=0.8, cutmix_alpha=1.0,
                 cutmix_minmax: Optional[Tuple[float, float]] = None, prob=1.0,
                 switch_prob=0.5, mode="batch", label_smoothing=0.1, num_classes=1000):
        if mode not in MODES:
            raise ValueError(f"unknown mixup mode {mode!r}")
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        self.prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    @property
    def active(self) -> bool:
        return self.mixup_alpha > 0 or self.cutmix_alpha > 0 or self.cutmix_minmax is not None

    def __call__(self, generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
        return mixup_cutmix_batch(
            generator, images, labels, self.num_classes, mixup_alpha=self.mixup_alpha,
            cutmix_alpha=self.cutmix_alpha, cutmix_minmax=self.cutmix_minmax, prob=self.prob,
            switch_prob=self.switch_prob, smoothing=self.label_smoothing, mode=self.mode)
