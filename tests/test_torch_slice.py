"""The whole serving slice: uint8 images in, fixed-size detections out,
through the JAX `get_inference_fn` and the port's `get_inference_fn` with
the same converted weights, at 128x256, batch 2, fp32; plus the port's
independence from jax and its CLI.

Detections must agree in number, classes and order. Boxes, scores and 3D
fields are within 1e-3 (absolute, relative 1e-4): the head outputs differ by
about 2e-6 (tests/test_torch_model.py) and the decode amplifies that at most
by the box and depth scales (strides up to 128, depths up to 80 m).

Order is only defined where scores are apart: with random weights, scores
deep in a 100-long list sit ~1e-6 apart, as close as the two frameworks'
score differences. So the weights are `detection_state_dict` (features that
carry the image, boxes that overlap) and the comparison keeps the top 20
detections per image, whose neighbouring scores are asserted to be more than
1e-4 apart.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu_torch.models.postprocess import get_inference_fn, unpack_detections

from tests.torch_port_util import both_models, detection_state_dict, fp32_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def detections():
    cfg = fp32_cfg()
    cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    jm, variables, pm = both_models(cfg, detection_state_dict())
    images = (np.random.RandomState(4).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    det_j = jax_get_inference_fn(jm, cfg)(variables, jnp.asarray(images), jnp.asarray(intrinsics))
    det_p = get_inference_fn(pm, cfg)(images, intrinsics)
    return {k: np.asarray(v) for k, v in det_j.items()}, det_p, intrinsics


def test_slice_matches_jax(detections):
    det_j, det_p, _ = detections
    det_p = {k: v.numpy() for k, v in det_p.items()}
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.all()
    assert np.diff(det_j["scores_3d"], axis=1).max() < -1e-4  # order is well defined
    np.testing.assert_array_equal(det_p["classes"][valid], det_j["classes"][valid])
    np.testing.assert_array_equal(det_p["fpn_levels"][valid], det_j["fpn_levels"][valid])
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], atol=1e-3, rtol=1e-4, err_msg=key)


def test_unpack_detections(detections):
    _det_j, det_p, intrinsics = detections
    batch = {"intrinsics": intrinsics, "image_size": np.array([[128, 256], [128, 256]])}
    meta = [{"image_id": "a", "width": 512, "height": 256}, {"image_id": "b"}]
    rows = unpack_detections(det_p, batch, meta)
    valid = det_p["valid"].numpy()
    assert [r["image_id"] for r in rows] == ["a", "b"]
    assert len(rows[0]["scores"]) == valid[0].sum()
    np.testing.assert_allclose(rows[0]["boxes2d"][:, 0::2].max(), min(512, 2 * det_p["boxes2d"][0][valid[0]][:, 0::2].max()))
    assert rows[1]["boxes3d_vec"].shape == (valid[1].sum(), 10)


def test_port_runs_without_jax():
    """Build the port's model and run inference in a fresh interpreter: no
    jax or flax module may be imported on the way (the GPU machine has none)."""
    code = (
        "import sys, torch\n"
        "from dd3d_tpu_torch.configs import get_experiment_cfg\n"
        "from dd3d_tpu_torch.models import build_model\n"
        "from dd3d_tpu_torch.models.postprocess import get_inference_fn\n"
        "cfg = get_experiment_cfg('dd3d_kitti_dla34')\n"
        "model = build_model(cfg, generator=torch.Generator().manual_seed(0))\n"
        "det = get_inference_fn(model, cfg)(torch.zeros(1, 128, 256, 3, dtype=torch.uint8), torch.eye(3)[None])\n"
        "assert det['boxes2d'].shape == (1, 100, 4)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_predict_cli_writes_json(tmp_path):
    """`python -m dd3d_tpu_torch.predict` on two synthetic PNGs."""
    import cv2

    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"{i:06d}.png"), (rng.rand(100, 330, 3) * 255).astype(np.uint8))
    out = tmp_path / "preds.json"
    cmd = [sys.executable, "-m", "dd3d_tpu_torch.predict", "--experiment", "dd3d_kitti_dla34",
           "--images", str(tmp_path), "--intrinsics", "721.5,721.5,609.5,172.8", "--out", str(out),
           "--device", "cpu", "--batch", "2", "INPUT.RESIZE.MIN_SIZE_TEST=128"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = json.loads(out.read_text())
    assert [r["image_id"] for r in records] == ["000000", "000001"]
    for r in records:
        assert len(r["scores"]) == len(r["boxes2d"]) == len(r["quat"]) > 0
        assert all(0 <= b[0] <= b[2] <= 330 and 0 <= b[1] <= b[3] <= 100 for b in r["boxes2d"])


def test_sample_aggregation_is_not_ported():
    from dd3d_tpu_torch.models import build_model

    cfg = fp32_cfg()
    cfg.DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE = True
    with pytest.raises(NotImplementedError, match="NUSC_SAMPLE_AGGREGATE"):
        get_inference_fn(build_model(cfg), cfg)

