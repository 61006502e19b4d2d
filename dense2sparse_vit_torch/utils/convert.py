"""JAX student parameters -> the port's state_dict (numpy only).

The port's modules follow the reference torch key layout, so this is the
same mapping as `dense2sparse_vit_tpu/utils/convert.py::export_student_state_dict`
for a `DiffPruningStudent` with LayerNorm predictors, written without the
JAX package (which this package must not import):

  conv kernels   (kH, kW, I, O) -> (O, I, kH, kW)
  dense kernels  (in, out)      -> (out, in)
  LayerNorm      scale / bias   -> weight / bias
  blocks_{i}/...                -> blocks.{i}....
  score_predictor_{p}/in_{j}    -> score_predictor.{p}.in_conv.{3j, 3j+1}
  score_predictor_{p}/out_{j}   -> score_predictor.{p}.out_conv.{3j, 3j+1}
  .../final_norm, final_dense   -> the last two entries of out_conv
  early_exit_norm, early_exit_head -> early_exit_head.{0, 1}

A BatchNorm predictor's norms (those with running statistics in the
variables' 'batch_stats') sit one level lower, under `bn`, as the
reference's BatchNormLayer has them (JAX `convert.py:227-251`):

  .../norm scale, bias           -> ....{3j}.bn.weight, .bn.bias
  batch_stats .../norm mean, var -> ....{3j}.bn.running_mean, .bn.running_var
                                    (.bn.num_batches_tracked: 0, which JAX
                                    does not count)

and, for the gumbel baseline's `DynamicViTStudent` (whose predictor units
are single layers, not LayerNorm + Dense pairs), the layout of the JAX
package's own map for that predictor (`convert.py:500-506`):

  score_predictor_{p}/in_norm, in_dense -> score_predictor.{p}.in_conv.{0, 1}
  score_predictor_{p}/out_{0,1,2}       -> score_predictor.{p}.out_conv.{0, 2, 4}

and the T2T stem onto the reference's `tokens_to_token.*` keys, as the JAX
package's `convert_t2t_state_dict` lays them out (`convert.py:400-460`),
from `stem/...` (the pruned T2T student binds its stem under its `stem`
attribute) or `tokens_to_token/...` (the dense `T2TViT`):

  attention{1,2}/prm_w                   -> attention{1,2}.w  (not transposed)
  attention{1,2}/kqv, proj, norm1, norm2 -> the same names (performer)
  attention{1,2}/mlp_fc1, mlp_fc2        -> attention{1,2}.mlp.0, .mlp.2
  attention{1,2}/qkv, proj               -> attention{1,2}.attn.qkv, .attn.proj
                                            (transformer unit; its mlp/fc1,
                                            fc2 and norms keep their names)
  conv_0, conv_1, conv_2                 -> soft_split0, soft_split1, project
  project                                -> project

A T2T model has no `pos_embed` parameter: its sinusoid table is a constant.

The DeiT, ViT and DINO backbones (`models/deit.py`, `deit_heads.py`,
`dino.py`) add these trees, as the reference's modules name them:

  dist_token, head_dist, predictor_fc1, predictor_fc2 -> the same names
  transformerheads_{i}/conv, token_fc   -> transformerheads.{i}.conv, .token_fc
  transformerheads_{i}/bn scale, bias   -> transformerheads.{i}.bn.weight, .bias
  batch_stats .../bn mean, var          -> ....bn.running_mean, .running_var
                                           (.num_batches_tracked: 0)
  spatialheads_{i}                      -> spatialheads.{i}
  predictor/in_norm, in_dense           -> predictor.in_conv.{0, 1} (DINO)
  predictor/out_{0,1,2}                 -> predictor.out_conv.{0, 2, 4}

The rest of the zoo (`models/t2t.py`'s SE, Ghost and Dense variants,
`models/tnt.py`, `models/resnet.py`) names its modules flat in JAX,
`{blocks,transition}_{i}_{name}`, which map to `{blocks,transition}.{i}.
{name}`, and:

  blocks_{i}_attn/cheap_q, .../cheap2    -> the same names (Ghost's
                                           per-channel scales, not
                                           transposed)
  pixel_embed_proj                       -> pixel_embed.proj (TNT)
  pixel_pos, patch_pos, norm1_proj, proj, norm2_proj -> the same names
  layer{s}_{b}/conv1 ... bn3             -> layer{s}.{b}.conv1 ... bn3
  layer{s}_{b}/downsample_conv, _bn      -> layer{s}.{b}.downsample.0, .1
  conv1, bn1, fc                         -> the same names (ResNet)
  batch_stats .../bn mean, var           -> ....running_mean, .running_var
                                            (.num_batches_tracked: 0)

`jax_params_from_state_dict` maps such a state_dict back (the backbones,
their heads and predictors, the blocks and the early-exit head, the T2T
stem under `tokens_to_token` (the dense T2T models' and the variants'
name), the T2T variants, TNT and the Drop-ResNet; not a student's score
predictors), and `resize_pos_embed` resizes a checkpoint's position
embedding to another grid (a 224-px checkpoint into a 384-px model).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _leaf(name: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias"}[name]


# the zoo's flat JAX names: per-block modules, per-stage transitions, ResNet
# units, and their top-level parameters and layers
_FLAT = re.compile(r"^(blocks|transition)_(\d+)_(.+)$")
_UNIT = re.compile(r"^(layer\d+)_(\d+)$")
_ZOO_TOP = ("pixel_embed_proj", "pixel_pos", "patch_pos", "norm1_proj", "proj", "norm2_proj",
            "conv1", "bn1", "fc")
_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _is_zoo(head: str) -> bool:
    return bool(_FLAT.match(head) or _UNIT.match(head)) or head in _ZOO_TOP


def _zoo_key(path: Tuple[str, ...]) -> str:
    """The port key of a T2T variant's, TNT's or the Drop-ResNet's parameter
    (or BatchNorm statistic)."""
    head, rest = path[0], list(path[1:])
    flat, unit = _FLAT.match(head), _UNIT.match(head)
    if flat:
        parts = list(flat.groups())
    elif unit:
        parts = list(unit.groups())
        rest[0] = _DOWNSAMPLE.get(rest[0], rest[0])
    else:
        parts = ["pixel_embed", "proj"] if head == "pixel_embed_proj" else [head]
    if rest:
        leaf = rest[-1]
        rest[-1] = _RUNNING.get(leaf) or {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join(parts + rest)


_DYNAMIC_VIT_UNITS = {"in_norm": "in_conv.0", "in_dense": "in_conv.1", "out_0": "out_conv.0",
                      "out_1": "out_conv.2", "out_2": "out_conv.4"}


_RUNNING = {"mean": "running_mean", "var": "running_var"}


def _predictor_key(path: Tuple[str, ...], n_out: int, bn_norms: set = frozenset()) -> str:
    """A predictor parameter's (or, for a path in `bn_norms`, which lists
    the BatchNorm norms, a running statistic's) port key."""
    p = int(path[0].rsplit("_", 1)[1])
    unit = path[1]
    if len(path) == 3 and unit in _DYNAMIC_VIT_UNITS:  # a DynamicViTPredictor's layer
        return f"score_predictor.{p}.{_DYNAMIC_VIT_UNITS[unit]}.{_leaf(path[-1])}"
    if unit in ("final_norm", "final_dense"):
        seq, idx = "out_conv", 3 * n_out + (unit == "final_dense")
    else:
        kind, j = unit.rsplit("_", 1)
        seq = "in_conv" if kind == "in" else "out_conv"
        idx = 3 * int(j) + (path[2] == "dense")
    leaf = path[-1]
    if path[:-1] in bn_norms:
        return f"score_predictor.{p}.{seq}.{idx}.bn.{_RUNNING.get(leaf) or _leaf(leaf)}"
    return f"score_predictor.{p}.{seq}.{idx}.{_leaf(leaf)}"


_STEM_CONVS = {"conv_0": "soft_split0", "conv_1": "soft_split1", "conv_2": "project"}
_PERFORMER_MLP = {"mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}


def _stem_key(path: Tuple[str, ...], attention_units: set) -> str:
    """A T2T stem param's port key; `attention_units` holds the units with
    a `qkv` layer (the transformer units, whose qkv and proj sit under
    `attn`)."""
    unit, rest = path[1], path[2:]
    if unit in _STEM_CONVS:
        return f"tokens_to_token.{_STEM_CONVS[unit]}.{_leaf(rest[-1])}"
    if unit == "project":
        return f"tokens_to_token.project.{_leaf(rest[-1])}"
    name = rest[0]
    if name == "prm_w":
        return f"tokens_to_token.{unit}.w"
    if name in ("qkv", "proj") and unit in attention_units:
        name = f"attn.{name}"
    name = _PERFORMER_MLP.get(name, name)
    return ".".join(("tokens_to_token", unit, name) + rest[1:-1] + (_leaf(rest[-1]),))


def resize_pos_embed(posemb: np.ndarray, n_tokens_new: int, n_extra: int = 1) -> np.ndarray:
    """Bilinearly resize the (1, N_old + n_extra, D) grid to n_tokens_new
    tokens in all (a copy of the JAX package's `utils/convert.py::
    resize_pos_embed`): the CLS (and distillation) slots pass through, the
    spatial grid is resized as a 2-D image with align_corners=False and no
    antialiasing."""
    tok, grid = posemb[:, :n_extra], posemb[0, n_extra:]
    gs_old = int(round(np.sqrt(grid.shape[0])))
    gs_new = int(round(np.sqrt(n_tokens_new - n_extra)))
    if gs_old == gs_new:
        return posemb
    D = grid.shape[-1]
    grid = grid.reshape(gs_old, gs_old, D)
    coords = (np.arange(gs_new) + 0.5) * (gs_old / gs_new) - 0.5
    c0 = np.clip(np.floor(coords).astype(int), 0, gs_old - 1)
    c1 = np.clip(c0 + 1, 0, gs_old - 1)
    w1 = np.clip(coords - c0, 0.0, 1.0)
    w0 = 1.0 - w1
    rows = grid[c0] * w0[:, None, None] + grid[c1] * w1[:, None, None]
    out = rows[:, c0] * w0[None, :, None] + rows[:, c1] * w1[None, :, None]
    return np.concatenate([tok, out.reshape(1, gs_new * gs_new, D)], axis=1)


_DINO_PREDICTOR = {"in_norm": "in_conv.0", "in_dense": "in_conv.1", "out_0": "out_conv.0",
                   "out_1": "out_conv.2", "out_2": "out_conv.4"}
_INDEXED = ("blocks_", "transformerheads_", "spatialheads_")


def _backbone_key(path: Tuple[str, ...]) -> str:
    """The port key of a DeiT-family parameter (or BatchNorm statistic)."""
    head, rest = path[0], list(path[1:])
    if head == "predictor":
        rest[0] = _DINO_PREDICTOR[rest[0]]
    for prefix in _INDEXED:
        if head.startswith(prefix):
            head = f"{prefix[:-1]}.{head[len(prefix):]}"
    leaf = rest[-1]
    rest[-1] = _RUNNING.get(leaf) or _leaf(leaf)
    return ".".join([head] + rest)


def state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """Map JAX `DiffPruningStudent` (with the DeiT or the T2T stem),
    `DynamicViTStudent`, `ViTTeacher`, `T2TViT` or DeiT, ViT and DINO
    backbone params (nested dicts of arrays) onto the port's state_dict
    keys. A full variables dict with a 'params' entry is accepted, and its
    'batch_stats' (a BatchNorm predictor's, the hierarchical heads') are
    mapped with it; the port's module then needs them. Returns numpy
    arrays: load them with
    `model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})`.
    """
    stats = {}
    if "params" in params and isinstance(params["params"], Mapping):
        stats = _flatten(params.get("batch_stats") or {})
        params = params["params"]
    flat = _flatten(params)
    head_stats = {p: v for p, v in stats.items()
                  if p[0].startswith("transformerheads_") or _is_zoo(p[0])}
    stats = {p: v for p, v in stats.items() if p not in head_stats}
    bn_norms = {path[:-1] for path in stats}
    n_out: Dict[str, int] = {}
    for path in flat:
        if path[0].startswith("score_predictor_") and path[1].startswith("out_"):
            n_out[path[0]] = max(n_out.get(path[0], 0), int(path[1][4:]) + 1)

    attention_units = {path[1] for path in flat
                       if path[0] in ("stem", "tokens_to_token") and path[2:3] == ("qkv",)}

    out: Dict[str, np.ndarray] = {}
    for path, v in flat.items():
        head = path[0]
        if head in ("cls_token", "pos_embed"):
            key = head
        elif head in ("stem", "tokens_to_token"):
            key = _stem_key(path, attention_units)
        elif _is_zoo(head):
            key = _zoo_key(path)
        elif head.startswith("blocks_"):
            key = ".".join(("blocks", head[len("blocks_"):]) + path[1:-1] + (_leaf(path[-1]),))
        elif head.startswith("score_predictor_"):
            key = _predictor_key(path, n_out[head], bn_norms)
        elif head == "early_exit_norm":
            key = f"early_exit_head.0.{_leaf(path[-1])}"
        elif head == "early_exit_head":
            key = f"early_exit_head.1.{_leaf(path[-1])}"
        elif head in ("patch_embed", "norm", "head"):
            key = ".".join(path[:-1] + (_leaf(path[-1]),))
        elif head in ("dist_token", "head_dist", "predictor_fc1", "predictor_fc2",
                      "predictor") or head.startswith(_INDEXED[1:]):
            key = head if head == "dist_token" else _backbone_key(path)
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        out[key] = np.array(v, order="C")  # a writable, contiguous copy
    for path, v in stats.items():
        out[_predictor_key(path, n_out[path[0]], bn_norms)] = np.array(v, order="C")
    for path in bn_norms:
        key = _predictor_key(path + ("mean",), n_out[path[0]], bn_norms)
        out[key.replace("running_mean", "num_batches_tracked")] = np.array(0, np.int64)
    for path, v in head_stats.items():
        mapped = _zoo_key if _is_zoo(path[0]) else _backbone_key
        out[mapped(path)] = np.array(v, order="C")
        key = mapped(path[:-1] + ("mean",))
        out[key.replace("running_mean", "num_batches_tracked")] = np.array(0, np.int64)
    return out


_STEM_UNITS = {"soft_split0": "conv_0", "soft_split1": "conv_1"}


def _stem_path(parts, ndim: int) -> list:
    """The JAX path (under `tokens_to_token`) of a T2T stem key's parts
    after `tokens_to_token`, its leaf still the port's: `_stem_key`'s
    inverse."""
    unit, rest = parts[0], parts[1:]
    if unit in _STEM_UNITS:
        return [_STEM_UNITS[unit]] + rest
    if unit == "project":
        return ["conv_2" if ndim == 4 else "project"] + rest
    if rest == ["w"]:
        return [unit, "prm_w"]
    if rest[0] == "attn":
        return [unit] + rest[1:]
    if rest[0] == "mlp" and rest[1] in ("0", "2"):
        return [unit, "mlp_fc1" if rest[1] == "0" else "mlp_fc2"] + rest[2:]
    return [unit] + rest


def _flat_names(keys) -> bool:
    """Whether a state_dict's blocks are named flat in JAX (the T2T SE,
    Ghost and Dense variants and TNT): their tell-tale keys."""
    return any(k == "pixel_pos" or k.startswith("transition.") or
               re.match(r"^blocks\.\d+\.(inner\.|attn\.se_fc1\.|attn\.cheap_q$)", k)
               for k in keys)


def _jax_path(key: str, flat: bool = False, ndim: int = 0) -> Tuple[Tuple[str, ...], str]:
    """(the JAX path, 'params' or 'batch_stats') of a port key, its leaf
    still the port's name; `flat`: the blocks are named flat in JAX
    (`_flat_names`); `ndim`: the value's, which tells a T2T stem's
    convolution `project` from its Linear one."""
    parts = key.split(".")
    if flat and parts[0] in ("blocks", "transition"):
        parts = [f"{parts[0]}_{parts[1]}_{parts[2]}"] + parts[3:]
    elif re.match(r"^layer\d+$", parts[0]):
        unit = {v: k for k, v in _DOWNSAMPLE.items()}.get(".".join(parts[2:4]))
        parts = [f"{parts[0]}_{parts[1]}"] + ([unit] + parts[4:] if unit else parts[2:])
    elif parts[0] == "pixel_embed":
        parts = ["pixel_embed_proj"] + parts[2:]
    elif parts[0] == "tokens_to_token":
        parts = ["tokens_to_token"] + _stem_path(parts[1:], ndim)
    elif parts[0] == "early_exit_head":
        parts = ["early_exit_norm" if parts[1] == "0" else "early_exit_head"] + parts[2:]
    elif parts[0] == "predictor":
        inv = {v: k for k, v in _DINO_PREDICTOR.items()}
        parts = ["predictor", inv[".".join(parts[1:3])]] + parts[3:]
    elif parts[0] + "_" in _INDEXED:
        parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
    elif parts[0] == "score_predictor":
        raise KeyError(f"no JAX path mapped for {key}")
    kind = "batch_stats" if parts[-1] in ("running_mean", "running_var") else "params"
    return tuple(parts), kind


def jax_params_from_state_dict(state_dict: Mapping) -> Dict[str, dict]:
    """The port's state_dict (tensors or arrays) -> a JAX variables dict
    {'params': ..., 'batch_stats': ...} ('batch_stats' only where there are
    BatchNorm statistics), the inverse of `state_dict_from_jax` for the
    DeiT, ViT and DINO backbones, their heads and predictors, the teacher,
    the blocks and the early-exit head, the dense T2T models and their
    stem, the T2T variants, TNT and the Drop-ResNet: conv kernels back to
    (kH, kW, I, O), dense kernels to (in, out), LayerNorm and BatchNorm
    weights to `scale`, running statistics to `mean` / `var`;
    num_batches_tracked, which JAX does not count, is dropped. Other
    parameters (positions, tokens, the performer's `prm_w`, Ghost's cheap
    scales) keep their values and names. Raises KeyError for a student's
    score predictor."""
    out: Dict[str, dict] = {}
    flat = _flat_names(state_dict)
    for key, v in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        v = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
        (*path, leaf), kind = _jax_path(key, flat, v.ndim)
        if leaf == "weight":
            if v.ndim == 4:
                leaf, v = "kernel", v.transpose(2, 3, 1, 0)
            elif v.ndim == 2:
                leaf, v = "kernel", v.T
            else:
                leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            leaf = leaf[len("running_"):]
        node = out.setdefault(kind, {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v, order="C")
    return out
