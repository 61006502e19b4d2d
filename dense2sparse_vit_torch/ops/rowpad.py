"""Token rows of any width on kernels that take 16-byte rows.

The Pallas kernels take token rows of any width (`ops/pallas/gather.py`
blocks whole rows of any D, `nn/layers.py`'s fused block has no width
condition). The port's GEMM engine (its TMA maps need 16-byte global
strides), its vector copies and its int8 products (K in steps of 16) take
rows whose bytes are a multiple of 16: a width that is a multiple of 8 in
bf16 (QUANTUM), of 16 in int8 (INT8_QUANTUM). An entry given rows of another
width pads them once, here, before it launches, and takes the padding off
what it returns (`Layout`):

- the residual stream's C columns go to Cp, zeros past C;
- where C itself is no multiple of the quantum, each head's d columns of
  q, k, v and of the attention output go to dp, zeros past d (Cp = H dp):
  zero q and k columns leave every score as it is, zero v columns give zero
  output columns; the caller's scale stays d^-0.5 of the true d;
- the hidden width goes to a multiple of the quantum, zeros past it
  (GELU(0) = 0);
- the LayerNorm parameters, weights, biases and int8 scales are zero in the
  padding, so every padded column of LN(x), of every product and of every
  residual sum is 0. All the kernels need to know is the LayerNorm
  statistics' true width, which each entry hands them (`ln_c`, the C
  code's `d2s::LnWidth`).

Gradients come back at the padded widths and are sliced: the pads'
gradients never reach a parameter. Nothing padded reaches the caller, the
state_dict, a checkpoint or an export. An aligned width takes none of
this: its entries launch as before (`block_layout` returns None).

Each padded launch counts in `PADDED[name]` (`counts`, `reset`), beside the
entry's own count. The functions that pad and unpad take the kernel call as
an argument, so that the CPU tests run them with the plain versions
standing in for the kernels (`ops.block.transformer_block_reference` with
`ln_width`, and the like).
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import torch

QUANTUM = 8  # bf16 values in 16 bytes
INT8_QUANTUM = 16  # the int8 products' K step (wgmma k32 on 16-byte TMA rows)

PADDED: Counter = Counter()


def counts() -> dict:
    """Padded launches by entry since the last `reset`."""
    return dict(PADDED)


def reset() -> None:
    PADDED.clear()


def aligned(n: int, q: int = QUANTUM) -> int:
    return -(-n // q) * q


@dataclass(frozen=True)
class Layout:
    """The padded widths of a block (or half-block) of width C = H d with a
    hidden width `hidden` (0: none): heads of dp columns, Cp = H dp, and hp
    hidden columns."""

    C: int
    H: int
    d: int
    dp: int
    hidden: int
    hp: int

    @property
    def Cp(self) -> int:
        return self.H * self.dp


def block_layout(C: int, H: int, hidden: int = 0, q: int = QUANTUM) -> Optional[Layout]:
    """The layout that puts a block of width C, H heads and `hidden` MLP
    columns on the kernels' q-multiples (H = 1 for the MLP half alone), or
    None where every width already is one. dp is the narrowest width from d
    up whose H dp is a multiple of q (no more than d rounded up to 16, so
    the attention cores' ceilings are d's)."""
    d = C // H
    dp = d
    if C % q:
        while (H * dp) % q:
            dp += 1
    hp = aligned(hidden, q)
    if dp == d and hp == hidden:
        return None
    return Layout(C, H, d, dp, hidden, hp)


@functools.lru_cache(maxsize=None)
def _index(layout: Layout, kind: str, device) -> torch.Tensor:
    """Where the true columns of `kind` sit in its padded width: "heads",
    the attention output's H d (head h's column j at h dp + j); "qkv", the
    packed q, k, v rows (3 H d)."""
    L = layout
    heads = (torch.arange(L.H)[:, None] * L.dp + torch.arange(L.d)[None]).reshape(-1)
    if kind == "qkv":
        heads = (torch.arange(3)[:, None] * L.Cp + heads[None]).reshape(-1)
    return heads.to(device)


def _dim(layout: Layout, kind: str):
    """(true size, padded size) of a dimension of `kind`."""
    L = layout
    return {"C": (L.C, L.Cp), "heads": (L.C, L.Cp), "qkv": (3 * L.C, 3 * L.Cp),
            "hidden": (L.hidden, L.hp)}[kind]


def pad(t: Optional[torch.Tensor], layout: Layout, *kinds: str) -> Optional[torch.Tensor]:
    """t with its last len(kinds) dimensions padded (zeros) to their
    padded sizes, each of the kind named ("C", "hidden": zeros after the
    true columns; "heads", "qkv": spread per head). None stays None."""
    if t is None:
        return None
    first = t.dim() - len(kinds)
    for i, kind in enumerate(kinds):
        dim = first + i
        n, npad = _dim(layout, kind)
        if npad == n:
            continue
        shape = list(t.shape)
        shape[dim] = npad
        out = t.new_zeros(shape)
        if kind in ("heads", "qkv"):
            out.index_copy_(dim, _index(layout, kind, t.device), t)
        else:
            out.narrow(dim, 0, n).copy_(t)
        t = out
    return t


def unpad(t: Optional[torch.Tensor], layout: Layout, *kinds: str) -> Optional[torch.Tensor]:
    """The inverse of `pad`: the true columns of t's last len(kinds)
    dimensions, contiguous. None stays None."""
    if t is None:
        return None
    first = t.dim() - len(kinds)
    for i, kind in enumerate(kinds):
        dim = first + i
        n, npad = _dim(layout, kind)
        if npad == n:
            continue
        if kind in ("heads", "qkv"):
            t = t.index_select(dim, _index(layout, kind, t.device))
        else:
            t = t.narrow(dim, 0, n)
    return t.contiguous()


# how each weight's dimensions pad, (out,) or (out, in), by key
WEIGHT_KINDS = {
    "ln1_w": ("C",), "ln1_b": ("C",), "ln2_w": ("C",), "ln2_b": ("C",),
    "ln_w": ("C",), "ln_b": ("C",),
    "wqkv": ("qkv", "C"), "bqkv": ("qkv",), "wproj": ("C", "heads"), "bproj": ("C",),
    "w1": ("hidden", "C"), "b1": ("hidden",), "w2": ("C", "hidden"), "b2": ("C",),
    # the int8 block's codes and per-output-channel scales
    "wqkv_q": ("qkv", "C"), "sqkv": ("qkv",), "wproj_q": ("C", "heads"), "sproj": ("C",),
    "w1_q": ("hidden", "C"), "s1": ("hidden",), "w2_q": ("C", "hidden"), "s2": ("C",),
}

# how each stage's last dimension pads, by key (ops.block's and the int8
# block's stages)
STAGE_KINDS = {"qkv": "qkv", "attn": "heads", "mid": "C", "hid": "hidden", "act": "hidden",
               "q1": "C", "q2": "heads", "q3": "C", "q4": "hidden"}


def pad_weights(w: dict, layout: Layout) -> dict:
    return {k: pad(v, layout, *WEIGHT_KINDS[k]) for k, v in w.items()}


def unpad_weights(w: dict, layout: Layout) -> dict:
    return {k: unpad(v, layout, *WEIGHT_KINDS[k]) for k, v in w.items()}


def unpad_stages(st: dict, layout: Layout) -> dict:
    return {k: unpad(v, layout, STAGE_KINDS[k]) if k in STAGE_KINDS else v
            for k, v in st.items()}


def count(name: str, result=None):
    """One padded (narrow) launch of the entry `name`, counted once the
    launch returned: `return count(name, launch(...))`."""
    PADDED[name] += 1
    return result
