"""The port's utils/coco.py and utils/profiling.py against the JAX
package's: the COCO-format export equal byte for byte
(tests/test_utils.py::test_coco_cache_export is JAX's own test), and the
profiling harness on the CPU (its CUDA barrier and CUDA-event timing run on
the card, in chip_smoke.py)."""
import json
import os

import numpy as np
import torch

from dd3d_tpu.utils.coco import create_coco_format_cache as jax_create_coco_format_cache
from dd3d_tpu_torch.utils.coco import create_coco_format_cache
from dd3d_tpu_torch.utils.profiling import annotate, timed, trace

DICTS = [
    {"file_name": "x.png", "image_id": "im0", "width": 100, "height": 80,
     "annotations": [{"category_id": 0, "bbox": [10, 10, 50, 40], "bbox3d": [1] * 10},
                     {"category_id": 2, "bbox": [np.float32(5.5), 3, 2, 9]}]},
    {"file_name": "y.png", "width": 64, "height": 48, "annotations": []},
    {"image_id": 7, "annotations": [{"category_id": 1, "bbox": [0, 0, 1, 1], "bbox3d": np.arange(10.0)}]},
]


def test_coco_cache_equals_jax(tmp_path):
    got = create_coco_format_cache(DICTS, ["Car", "Pedestrian", "Cyclist"], "fixture", str(tmp_path / "port"))
    want = jax_create_coco_format_cache(DICTS, ["Car", "Pedestrian", "Cyclist"], "fixture", str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want) == "fixture_coco_format.json"
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    payload = json.load(open(got))
    assert payload["annotations"][0]["bbox"] == [10.0, 10.0, 40.0, 30.0]
    assert payload["annotations"][1]["area"] == 0.0  # x2 < x1: no area
    assert [i["image_id_str"] for i in payload["images"]] == ["im0", "1", "7"]


def test_profiling_harness_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")):
        with annotate("matmul"):
            y = x @ x
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "matmul" in f.read()
    seconds, out = timed(lambda a: {"y": a @ a}, x, iters=3, warmup=1)
    assert seconds > 0 and torch.equal(out["y"], y)
