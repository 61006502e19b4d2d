"""Load the reference's own PyTorch model code (the DynamicViT release's
`vit_models/`) without timm installed.

The reference depends on timm 0.4.12; everything it takes from timm is
small (constants, DropPath, to_2tuple, trunc_normal_, Mlp, a registry
decorator, SoftTargetCrossEntropy), so a minimal shim is installed into
sys.modules and the reference modules are loaded under a synthetic package,
so that their relative imports resolve. The port's own copy of the test
suite's loader: `experiments.parity_report` builds the reference student
through it.
"""

from __future__ import annotations

import importlib
import math
import os
import sys
import types

_PKG = "refvit"


def _install_timm_shim() -> None:
    if "timm" in sys.modules:
        return

    import torch
    import torch.nn as nn

    timm = types.ModuleType("timm")
    data = types.ModuleType("timm.data")
    data.IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
    data.IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

    models = types.ModuleType("timm.models")
    layers = types.ModuleType("timm.models.layers")

    def to_2tuple(x):
        return x if isinstance(x, tuple) else (x, x)

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        # inverse-CDF truncated normal, matching timm's _no_grad_trunc_normal_
        def norm_cdf(v):
            return (1.0 + math.erf(v / math.sqrt(2.0))) / 2.0

        with torch.no_grad():
            lo, up = norm_cdf((a - mean) / std), norm_cdf((b - mean) / std)
            tensor.uniform_(2 * lo - 1, 2 * up - 1)
            tensor.erfinv_()
            tensor.mul_(std * math.sqrt(2.0)).add_(mean)
            tensor.clamp_(min=a, max=b)
            return tensor

    class DropPath(nn.Module):
        def __init__(self, drop_prob=None):
            super().__init__()
            self.drop_prob = drop_prob or 0.0

        def forward(self, x):
            if self.drop_prob == 0.0 or not self.training:
                return x
            keep = 1 - self.drop_prob
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            mask = keep + torch.rand(shape, dtype=x.dtype, device=x.device)
            return x.div(keep) * mask.floor_()

    class Mlp(nn.Module):
        def __init__(self, in_features, hidden_features=None,
                     out_features=None, act_layer=nn.GELU, drop=0.0):
            super().__init__()
            out_features = out_features or in_features
            hidden_features = hidden_features or in_features
            self.fc1 = nn.Linear(in_features, hidden_features)
            self.act = act_layer()
            self.fc2 = nn.Linear(hidden_features, out_features)
            self.drop = nn.Dropout(drop)

        def forward(self, x):
            return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))

    layers.to_2tuple = to_2tuple
    layers.trunc_normal_ = trunc_normal_
    layers.DropPath = DropPath
    layers.Mlp = Mlp

    loss_mod = types.ModuleType("timm.loss")

    class SoftTargetCrossEntropy(nn.Module):
        def forward(self, x, target):
            return torch.mean(
                torch.sum(-target * torch.nn.functional.log_softmax(x, -1), -1)
            )

    loss_mod.SoftTargetCrossEntropy = SoftTargetCrossEntropy

    registry = types.ModuleType("timm.models.registry")
    registry.register_model = lambda fn: fn

    helpers = types.ModuleType("timm.models.helpers")

    def load_pretrained(*a, **k):  # factories with pretrained=True only
        raise RuntimeError("pretrained downloads are not available: load a local checkpoint")

    helpers.load_pretrained = load_pretrained

    models.layers = layers
    models.registry = registry
    models.helpers = helpers
    timm.data = data
    timm.models = models

    timm.loss = loss_mod
    for name, mod in {
        "timm": timm,
        "timm.data": data,
        "timm.models": models,
        "timm.models.layers": layers,
        "timm.models.registry": registry,
        "timm.models.helpers": helpers,
        "timm.loss": loss_mod,
    }.items():
        sys.modules[name] = mod


def load_reference_module(name: str, reference_dir: str):
    """`reference_dir`/<name>.py as module refvit.<name>; raises
    FileNotFoundError naming the directory where it does not exist."""
    if not os.path.isdir(reference_dir):
        raise FileNotFoundError(f"no reference model code: {reference_dir} is not a directory")
    _install_timm_shim()
    pkg = sys.modules.get(_PKG)
    if pkg is None:
        pkg = types.ModuleType(_PKG)
        pkg.__package__ = _PKG
        sys.modules[_PKG] = pkg
    pkg.__path__ = [os.path.abspath(reference_dir)]
    return importlib.import_module(f"{_PKG}.{name}")
