"""Dataset/metadata catalogs: lazy registries keyed by dataset name; the
port's own copy of dd3d_tpu/data/catalog.py.

Rebuild of detectron2's DatasetCatalog/MetadataCatalog usage in the reference
(tridet/data/datasets/kitti_3d/build.py:17-18, registration at
tridet/data/datasets/__init__.py:12-24). Datasets are registered as lazy
builder thunks; metadata carries class names, evaluator and visualizer ids.
Only the KITTI-3D family is ported; nuScenes and the JSON datasets are not
(ROADMAP §1 item 9).
"""
from typing import Callable, Dict

_DATASETS: Dict[str, Callable] = {}
_METADATA: Dict[str, dict] = {}


class DatasetCatalog:
    @staticmethod
    def register(name: str, fn: Callable):
        _DATASETS[name] = fn

    @staticmethod
    def get(name: str):
        if name not in _DATASETS:
            raise KeyError(f"Dataset {name!r} not registered; known: {sorted(_DATASETS)}")
        return _DATASETS[name]()

    @staticmethod
    def list():
        return sorted(_DATASETS)


class MetadataCatalog:
    @staticmethod
    def get(name: str) -> dict:
        return _METADATA.setdefault(name, {"name": name})


def register_datasets(cfg):
    """Register the ported dataset families (lazy): KITTI-3D. cf.
    tridet/data/datasets/__init__.py:12-24."""
    from dd3d_tpu_torch.data.datasets.kitti_3d import register_kitti_3d_datasets

    return register_kitti_3d_datasets(cfg)
