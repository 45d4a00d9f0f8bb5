"""COCO-format dataset cache exporter, counterpart of dd3d_tpu/utils/coco.py
(the reference's tridet/utils/coco.py:151-193): dataset dicts serialized as
a COCO-format JSON for tooling outside the package. The port's COCO
evaluator reads the catalog directly; the export is the same surface, and
the same file byte for byte (tests/test_torch_utils.py)."""
import json
import logging
import os
import tempfile
from typing import List, Optional

LOG = logging.getLogger(__name__)


def create_coco_format_cache(dataset_dicts: List[dict], class_names: List[str], dataset_name: str,
                             cache_dir: Optional[str] = None) -> str:
    """Write `<cache_dir>/<dataset_name>_coco_format.json` and return its
    path: images with their ids, xyxy boxes as COCO's xywh with areas, the
    3D boxes where present, categories by index. `cache_dir` defaults to
    the temporary directory (TMPDIR)."""
    images, annotations = [], []
    ann_id = 1
    for img_id, d in enumerate(dataset_dicts):
        images.append({
            "id": img_id,
            "file_name": d.get("file_name", ""),
            "width": int(d.get("width", 0)),
            "height": int(d.get("height", 0)),
            "image_id_str": str(d.get("image_id", img_id)),
        })
        for a in d.get("annotations", []):
            x1, y1, x2, y2 = a["bbox"]
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": int(a["category_id"]),
                "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                "area": float(max(x2 - x1, 0) * max(y2 - y1, 0)),
                "iscrowd": 0,
                **({"bbox3d": list(map(float, a["bbox3d"]))} if "bbox3d" in a else {}),
            })
            ann_id += 1
    payload = {
        "info": {"description": dataset_name},
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i, "name": n} for i, n in enumerate(class_names)],
    }
    cache_dir = cache_dir or tempfile.gettempdir()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{dataset_name}_coco_format.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    LOG.info("COCO-format cache: %s (%d images, %d annotations)", path, len(images), len(annotations))
    return path
