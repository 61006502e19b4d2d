"""What the experiment drivers share: the device an entry point runs on."""

from __future__ import annotations

import torch


def entry_device(device, what: str) -> torch.device:
    """`device`, by default the card; raises where the card is asked for
    (or defaulted to) and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on {device} and there is no CUDA device: pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    return device


def model_kwargs(device: torch.device) -> dict:
    """The compute settings of an experiment's model: on the card bf16 through
    the kernels, on the CPU fp32 through the plain layers."""
    if device.type == "cuda":
        return {"dtype": "bfloat16", "use_fused_attention": True}
    return {"dtype": "float32", "use_fused_attention": False}
