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
"""

from __future__ import annotations

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


_DYNAMIC_VIT_UNITS = {"in_norm": "in_conv.0", "in_dense": "in_conv.1", "out_0": "out_conv.0",
                      "out_1": "out_conv.2", "out_2": "out_conv.4"}


def _predictor_key(path: Tuple[str, ...], n_out: int) -> str:
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
    return f"score_predictor.{p}.{seq}.{idx}.{_leaf(path[-1])}"


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


def state_dict_from_jax(params: Mapping) -> Dict[str, np.ndarray]:
    """Map JAX `DiffPruningStudent` (with the DeiT or the T2T stem),
    `DynamicViTStudent`, `ViTTeacher` or `T2TViT` params (nested dicts of
    arrays; a full variables dict with a 'params' entry is accepted) onto
    the port's
    state_dict keys. Returns numpy arrays: load them with
    `model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})`.
    """
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    flat = _flatten(params)
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
        elif head.startswith("blocks_"):
            key = ".".join(("blocks", head[len("blocks_"):]) + path[1:-1] + (_leaf(path[-1]),))
        elif head.startswith("score_predictor_"):
            key = _predictor_key(path, n_out[head])
        elif head in ("patch_embed", "norm", "head"):
            key = ".".join(path[:-1] + (_leaf(path[-1]),))
        else:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        out[key] = np.array(v, order="C")  # a writable, contiguous copy
    return out
