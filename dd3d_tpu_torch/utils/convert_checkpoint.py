"""JAX-package variables -> the port's state dict.

`convert_flax_variables` turns dd3d_tpu's `{"params", "batch_stats"}` trees,
given as nested dicts of numpy arrays, into a state dict for a port model:
- conv kernels HWIO -> OIHW;
- each level's norm of a shared head tower (`cls_tower_norm{i}.norm{l}`)
  -> `cls_tower.{i}.norm.{l}`;
- `Scale` / `Offset` scalars -> `scales_*.{l}.scale` / `offsets_*.{l}.bias`;
- FrozenBN statistics (all in `batch_stats`) and live-BN affine (in
  `params`) -> weight / bias / running_mean / running_var.
The port's names are the reference checkpoints' (tests/torch_ref_dd3d.py),
so a reference `.pth` loads into the same model with `strict=True`. Buffers
the JAX trees do not hold (num_batches_tracked, pixel_mean / pixel_std, the
per-level depth statistics) are the model's own, which come from the config.
"""
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from dd3d_tpu_torch.models.layers import (
    ConvNorm,
    FoldableBatchNorm,
    FrozenBatchNorm,
    Offset,
    Scale,
)

# Buffers of the port that have no counterpart in the JAX variables.
MODEL_ONLY_BUFFERS = ("num_batches_tracked", "pixel_mean", "pixel_std", "mean_depth_per_level",
                      "std_depth_per_level")

_PATH_RULES = [
    (r"\blevel([01])\.(\d+)\b", r"level\1_conv\2"),
    (r"\btop_block\.(p[67])\b", r"top_\1"),
    (r"\b(cls_tower|box2d_tower|box3d_tower)\.(\d+)\.norm\.(\d+)\b", r"\1_norm\2.norm\3"),
    (r"\b(cls_tower|box2d_tower|box3d_tower)\.(\d+)\b", r"\1_conv\2"),
    (r"\bscales_([a-z0-9_]+?)\.(\d+)\b", r"scale_\1\2"),
    (r"\boffsets_([a-z0-9_]+?)\.(\d+)\b", r"offset_\1\2"),
    (r"\b(box3d_[a-z]+)\.(\d+)\b", r"\1\2"),
]

_NORM_LEAVES = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _flax_module_path(module_name: str, fpn_features: Dict[str, str]) -> List[str]:
    p = module_name
    for pattern, repl in _PATH_RULES:
        p = re.sub(pattern, repl, p)
    # FPN convs are named by trunk feature in flax: fpn_lateral3 -> fpn_lateral_level3
    p = re.sub(r"\bfpn_(lateral|output)(\d)\b", lambda m: f"fpn_{m.group(1)}_{fpn_features[m.group(2)]}", p)
    return p.split(".") if p else []


def _flax_leaf(module, path: List[str], leaf: str) -> Tuple[str, List[str], str]:
    """(collection, module path, leaf name) of one port tensor in the JAX trees."""
    if isinstance(module, FrozenBatchNorm):
        names = {"weight": ("batch_stats", "scale"), "bias": ("batch_stats", "bias"), **_NORM_LEAVES}
        coll, name = names[leaf]
        return coll, path, name
    if isinstance(module, FoldableBatchNorm):
        names = {"weight": ("params", "scale"), "bias": ("params", "bias"), **_NORM_LEAVES}
        coll, name = names[leaf]
        return coll, path, name
    if isinstance(module, (Scale, Offset)):
        return "params", path, leaf
    if leaf in ("weight", "bias"):
        # ConvNorm holds its conv as a `conv` child in flax; a bare conv does not.
        sub = path + ["conv"] if isinstance(module, ConvNorm) else path
        return "params", sub, "kernel" if leaf == "weight" else "bias"
    raise KeyError(f"no JAX counterpart for {'.'.join(path)}.{leaf} ({type(module).__name__})")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _to_dict(tree):
    """Plain nested dicts of numpy arrays (accepts flax FrozenDicts)."""
    if hasattr(tree, "items"):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert_flax_variables(variables: Dict, model: torch.nn.Module, strict: bool = True) -> Dict[str, torch.Tensor]:
    """State dict for `model` from JAX variables {"params", "batch_stats"}.
    With `strict`, every JAX leaf must be used and every shape must agree."""
    trees = {"params": _to_dict(variables.get("params", {})), "batch_stats": _to_dict(variables.get("batch_stats", {}))}
    backbone = trees["params"].get("backbone", {})
    fpn_features = {}
    for key in backbone:
        m = re.match(r"fpn_lateral_([a-z]+)(\d)$", key)
        if m:
            fpn_features[m.group(2)] = m.group(1) + m.group(2)

    state, used = {}, set()
    for mod_name, module in model.named_modules():
        own = list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False))
        for leaf, tensor in own:
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            if leaf in MODEL_ONLY_BUFFERS:
                state[key] = tensor.detach().cpu().clone()
                continue
            coll, path, name = _flax_leaf(module, _flax_module_path(mod_name, fpn_features), leaf)
            node = trees[coll]
            for part in path:
                node = node[part]
            value = node[name]
            if value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{key}: JAX {coll}/{'/'.join(path)}/{name} has shape {value.shape}, "
                                 f"the port {tuple(tensor.shape)}")
            state[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
            used.add((coll,) + tuple(path) + (name,))
    if strict:
        unused = [c + "/" + "/".join(p) for c in trees for p in _leaves(trees[c]) if (c,) + p not in used]
        if unused:
            raise ValueError(f"{len(unused)} JAX leaves have no place in the port: {unused[:10]}")
    return state
