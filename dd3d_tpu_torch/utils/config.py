"""Hierarchical config tree mirroring the reference's Hydra/OmegaConf surface:
the port's own copy of dd3d_tpu/utils/config.py.

The reference composes YAML groups into one uppercase-keyed OmegaConf tree
(`configs/defaults.yaml:1-11`, consumed via `@hydra.main` in
`scripts/train.py:40`). We keep the same key names (`DD3D.FCOS2D.*`,
`SOLVER.*`, ...) on a plain attribute-dict with deep-merge "experiment deltas"
— no Hydra/detectron2 dependency.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping


class CfgNode(dict):
    """A dict with attribute access and recursive deep-merge.

    Mirrors the ergonomics of detectron2's CfgNode / OmegaConf used throughout
    the reference (e.g. `cfg.DD3D.FCOS2D.LOSS.ALPHA`).
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    @classmethod
    def from_dict(cls, d: Mapping) -> "CfgNode":
        node = cls()
        for k, v in d.items():
            node[k] = cls.from_dict(v) if isinstance(v, Mapping) else v
        return node

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge(self, delta: Mapping) -> "CfgNode":
        """Recursively merge `delta` into a copy of self and return it."""
        out = self.clone()
        _merge_into(out, delta)
        return out

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    @classmethod
    def from_yaml(cls, path: str) -> "CfgNode":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def merge_from_file(self, path: str) -> "CfgNode":
        """Merge a YAML experiment-delta file (the reference's
        `@package _global_` experiment yamls) into a copy of self."""
        return self.merge(CfgNode.from_yaml(path))

    def dump_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _merge_into(base: CfgNode, delta: Mapping) -> None:
    for k, v in delta.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), CfgNode):
            _merge_into(base[k], v)
        elif isinstance(v, Mapping):
            base[k] = CfgNode.from_dict(v)
        else:
            base[k] = copy.deepcopy(v)
