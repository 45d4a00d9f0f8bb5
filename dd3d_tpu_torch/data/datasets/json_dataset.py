"""JSON-manifest datasets: register any dataset from a self-describing file;
the port's copy of dd3d_tpu/data/datasets/json_dataset.py.

The reference consumes datasets exclusively through detectron2's
DatasetCatalog thunks (tridet/data/datasets/__init__.py:12-24) and ships a
COCO-format cache writer (tridet/utils/coco.py:151-193). This module is the
generic inverse: a directory of `<DATASET_ROOT>/json_datasets/*.json`
manifests, each carrying its own dataset dicts + metadata, registers as a
first-class dataset — usable for custom data, for materialized/cached
datasets, and for fixture-driven end-to-end tests of the full CLI.

Manifest schema:
    {
      "name": "my_dataset",
      "metadata": {"thing_classes": [...], "evaluators": [...], ...},
      "dicts": [ {file_name, intrinsics, annotations: [...], ...}, ... ]
    }

Relative `file_name`s resolve against the manifest's directory.
"""
import json
import logging
import os
from typing import List

from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

LOG = logging.getLogger(__name__)


# One parse per manifest per process: register_json_datasets needs the
# header (name/metadata) and the thunk needs the dicts — without a cache a
# large materialized manifest would be fully json-parsed twice (and once
# per register_datasets call even when never used).
_MANIFEST_CACHE: dict = {}


def _load_manifest(path: str) -> dict:
    key = (path, os.path.getmtime(path))
    if key not in _MANIFEST_CACHE:
        # Keep ONE manifest live: materialized manifests can be huge, and
        # registration touches every manifest in the directory — a larger
        # bound would pin several of them in memory for the process
        # lifetime next to the training job.
        _MANIFEST_CACHE.clear()
        with open(path) as f:
            _MANIFEST_CACHE[key] = json.load(f)
    return _MANIFEST_CACHE[key]


def load_json_dataset(path: str) -> List[dict]:
    manifest = _load_manifest(path)
    base = os.path.dirname(os.path.abspath(path))
    dicts = manifest["dicts"]
    for d in dicts:
        fn = d.get("file_name")
        if fn and not os.path.isabs(fn):
            d["file_name"] = os.path.join(base, fn)
    return dicts


def register_json_datasets(cfg) -> List[str]:
    root = os.path.join(
        cfg.get("DATASET_ROOT", os.environ.get("DATASET_ROOT", "/data/datasets")), "json_datasets"
    )
    names = []
    if not os.path.isdir(root):
        return names
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".json"):
            continue
        path = os.path.join(root, fname)
        try:
            manifest = _load_manifest(path)
        except (OSError, json.JSONDecodeError) as e:
            LOG.warning("Skipping unreadable dataset manifest %s: %s", path, e)
            continue
        name = manifest.get("name") or os.path.splitext(fname)[0]
        DatasetCatalog.register(name, (lambda path=path: load_json_dataset(path)))
        md = MetadataCatalog.get(name)
        md.update(manifest.get("metadata", {}))
        md.setdefault("root_dir", os.path.dirname(path))
        names.append(name)
        LOG.info("Registered JSON dataset %r from %s", name, path)
    return names
