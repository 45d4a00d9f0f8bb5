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
but for VoVNet's (see `reference_to_port_names`), so a reference `.pth`
loads into the same model with `strict=True`. VoVNet's modules carry the
flax scope names (`stem1`, `OSA2_1`, `layer0`, `dw` / `pw`, `ese.fc`), which
the path rules below pass through unchanged. Buffers
the JAX trees do not hold (num_batches_tracked, pixel_mean / pixel_std, the
per-level depth statistics) are the model's own, which come from the config.

`assign_quant_paths` gives every quantizable conv the flax scope path that
keys its int8 scale, so one scales JSON serves both packages.

`flax_param_paths` names every trainable parameter of the port by its flax
path (the weight-decay mask reads it), and `convert_flax_params` converts a
tree shaped like the JAX params, e.g. a gradient tree, to port names.

`reference_to_port_names` renames a reference checkpoint for the port:
VoVNet's slash names (`stem.stem_1/conv.weight`), which no nn.Module name
can hold, become the port's (`stem1.weight`); for NuscenesDD3D, whose DD3D
the port (like JAX) nests under `base` while the reference keeps it at the
root beside `attr_logits` and `speed`, the DD3D names gain `base.`; the per-level depth
Scale / Offset entries past the model's levels, which the reference sizes by
the dataset's depth statistics, are dropped, as the JAX converter drops them.
"""
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from dd3d_tpu_torch.models.layers import (
    ConvNorm,
    FoldableBatchNorm,
    FoldableConv,
    FrozenBatchNorm,
    Offset,
    PredictorConv,
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

# The JAX package's canonicalization of VoVNet's OrderedDict slash names
# (dd3d_tpu/utils/convert_checkpoint.py:26-38): the reference's
# `.stage2.OSA2_1.layers.0.OSA2_1_0/conv.` becomes `.OSA2_1.layer0.conv.`.
_VOVNET_RULES = [
    (r"\.stage\d+\.(OSA)", r".\1"),  # drop the _OSA_stage level
    (r"\.stem\.stem_(\d)/", r".stem\1."),
    (r"\.layers\.(\d+)\.[^./]+/dw_conv3x3\.", r".layer\1.dw."),
    (r"\.layers\.(\d+)\.[^./]+/pw_conv1x1\.", r".layer\1.pw.conv."),
    (r"\.layers\.(\d+)\.[^./]+/pw_norm\.", r".layer\1.pw.norm."),
    (r"\.layers\.(\d+)\.[^./]+/(conv|norm)\.", r".layer\1.\2."),
    (r"\.concat\.[^./]+/(conv|norm)\.", r".concat.\1."),
    (r"\.conv_reduction\.[^./]+/(conv|norm)\.", r".conv_reduction.\1."),
]
_PER_LEVEL_SCALAR = re.compile(r"^(.*\.(?:scales|offsets)_[a-z0-9_]+)\.(\d+)\.(?:scale|bias)$")

_NORM_LEAVES = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _flax_module_path(module_name: str, fpn_features: Dict[str, str]) -> List[str]:
    p = module_name
    for pattern, repl in _PATH_RULES:
        p = re.sub(pattern, repl, p)
    # FPN convs are named by trunk feature in flax: fpn_lateral3 -> fpn_lateral_level3
    p = re.sub(r"\bfpn_(lateral|output)(\d)\b", lambda m: f"fpn_{m.group(1)}_{fpn_features[m.group(2)]}", p)
    return p.split(".") if p else []


def _model_fpn_features(model: torch.nn.Module) -> Dict[str, str]:
    """{stride digit: trunk feature} of a DD3D model's FPN (NuscenesDD3D's
    under `base`); {} for a bare trunk."""
    fpn = getattr(getattr(model, "base", model), "backbone", None)
    if fpn is None:
        return {}
    return {str(fpn.in_strides[f].bit_length() - 1): f for f in fpn.in_features}


def assign_quant_paths(model: torch.nn.Module) -> None:
    """Set `quant_path` on every quantizable conv of a DD3D model to its flax
    scope path ("/"-joined): a ConvNorm's conv is its `conv` child
    (`backbone/bottom_up/level2/root/conv/conv`), a tower conv and a
    predictor are the module itself (`fcos2d_head/cls_tower_conv0`,
    `fcos3d_head/box3d_quat0`; a fused predictor group is keyed by its first
    sibling)."""
    fpn_features = _model_fpn_features(model)
    for name, module in model.named_modules():
        if isinstance(module, PredictorConv) or (isinstance(module, FoldableConv) and module.quantizable):
            path = _flax_module_path(name, fpn_features)
            module.quant_path = "/".join(path + ["conv"] if isinstance(module, ConvNorm) else path)


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


def flax_param_paths(model: torch.nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{port parameter name: its flax path in the JAX params, leaf included},
    e.g. fcos2d_head.cls_tower.0.norm.3.weight ->
    (fcos2d_head, cls_tower_norm0, norm3, scale)."""
    fpn_features = _model_fpn_features(model)
    paths = {}
    for mod_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            coll, path, name = _flax_leaf(module, _flax_module_path(mod_name, fpn_features), leaf)
            if coll != "params":
                raise ValueError(f"{mod_name}.{leaf} is trainable in the port but lives in JAX's {coll}")
            paths[f"{mod_name}.{leaf}" if mod_name else leaf] = tuple(path) + (name,)
    return paths


def convert_flax_params(params, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{port parameter name: tensor} from a tree with the structure of the
    JAX params (the params themselves, or their gradients); conv kernels
    HWIO -> OIHW. Every leaf must be used."""
    tree = _to_dict(params)
    out, used = {}, set()
    for key, path in flax_param_paths(model).items():
        node = tree
        for part in path:
            node = node[part]
        value = node.transpose(3, 2, 0, 1) if node.ndim == 4 else node
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
        used.add(path)
    unused = [p for p in _leaves(tree) if p not in used]
    if unused:
        raise ValueError(f"{len(unused)} JAX leaves have no place in the port: {unused[:10]}")
    return out


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
    # NuscenesDD3D nests DD3D under `base` (dd3d_tpu/utils/convert_checkpoint.py:185-191)
    backbone = trees["params"].get("backbone") or trees["params"].get("base", {}).get("backbone", {})
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
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
            used.add((coll,) + tuple(path) + (name,))
    if strict:
        unused = [c + "/" + "/".join(p) for c in trees for p in _leaves(trees[c]) if (c,) + p not in used]
        if unused:
            raise ValueError(f"{len(unused)} JAX leaves have no place in the port: {unused[:10]}")
    return state


def _vovnet_port_name(key: str) -> str:
    k = key
    for pattern, repl in _VOVNET_RULES:
        k = re.sub(pattern, repl, k)
    if k != key:  # a ConvNorm's conv is the port module itself: `stem1.conv.weight` -> `stem1.weight`
        k = re.sub(r"\.conv\.(weight|bias)$", r".\1", k)
    return k


def reference_to_port_names(state_dict: Dict[str, torch.Tensor], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A reference-named state dict with the port's names, for
    `model.load_state_dict(..., strict=True)`. A per-level scale or offset
    is dropped only when the model has fewer levels than the entry's index;
    every other key is kept, so a key the model lacks still fails the load."""
    own = model.state_dict()
    out = {}
    for key, value in state_dict.items():
        name = _vovnet_port_name(key)
        if name not in own and f"base.{name}" in own:
            name = f"base.{name}"  # NuscenesDD3D: the reference's DD3D modules sit at the root
        m = _PER_LEVEL_SCALAR.match(name)
        if m and name not in own and sum(k.startswith(m.group(1) + ".") for k in own) <= int(m.group(2)):
            continue
        out[name] = value
    return out
