"""Static int8 calibration and serving: the port (dd3d_tpu_torch) against the
JAX package on the same converted weights and uint8 images, at 128x256,
batch 2, fp32, in bench.py's serving configuration (QUANT_INT8,
QUANT_MIN_CH=32, QUANT_UNFOLDED).

What agrees exactly: the scales files' keys (flax scope paths) and shape
tags, and the first layers' calibrated maxima. What does not, and why: the
JAX calibration and serving run jitted, and XLA's fused int8 dequant on the
CPU rounds 1 ulp away from the written f32 arithmetic in a few percent of
outputs (eager JAX matches the port bit for bit, tests/test_torch_int8.py).
Each such ulp can move an int8 code downstream by one step, and ~30 stacked
int8 convs with random weights compound that: calibrated maxima differ by at
most 3.4e-2 relative (median 6e-3), sorted detection scores by at most 9.3e-3
(measured here); the bounds are 5e-2 and 2e-2.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from dd3d_tpu.models.calibrate import prepare_static_scales as jax_prepare_static_scales
from dd3d_tpu.models.layers import load_quant_scales as jax_load_quant_scales
from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu_torch.models.calibrate import capture_scales, prepare_static_scales
from dd3d_tpu_torch.models.layers import load_quant_scales
from dd3d_tpu_torch.models.postprocess import get_inference_fn

from tests.torch_port_util import both_models, detection_state_dict, fp32_cfg, jax_quant_globals_restored, torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)
FIRST_SITES = ("backbone/bottom_up/base_layer/conv", "backbone/bottom_up/level0_conv0/conv")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


def serving_cfg():
    cfg = fp32_cfg()
    cfg.TPU.QUANT_INT8 = True
    cfg.TPU.QUANT_MIN_CH = 32
    cfg.TPU.QUANT_UNFOLDED = True
    cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    return cfg


@pytest.fixture(scope="module")
def calibrated():
    cfg = serving_cfg()
    jm, variables, pm = both_models(cfg, detection_state_dict())
    images = (np.random.RandomState(4).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    with jax_quant_globals_restored():
        cfg_j = jax_prepare_static_scales(cfg, jm, variables, [jnp.asarray(images)], tag="test")
        det_j = jax_get_inference_fn(jm, cfg_j)(variables, jnp.asarray(images), jnp.asarray(intrinsics))
        det_j = {k: np.asarray(v) for k, v in det_j.items()}
    cfg_p = prepare_static_scales(cfg, pm, [images], tag="test")
    return dict(cfg=cfg, pm=pm, images=images, intrinsics=intrinsics, cfg_j=cfg_j, cfg_p=cfg_p, det_j=det_j,
                scales_j=jax_load_quant_scales(cfg_j.TPU.QUANT_SCALES_PATH),
                scales_p=load_quant_scales(cfg_p.TPU.QUANT_SCALES_PATH))


def test_prepare_static_scales_returns_a_serving_cfg(calibrated):
    cfg, cfg_p = calibrated["cfg"], calibrated["cfg_p"]
    assert cfg_p is not cfg and not cfg.TPU.get("QUANT_SCALES_PATH")
    assert cfg_p.TPU.QUANT_INT8 and cfg_p.TPU.QUANT_MIN_CH == 32  # the caller's gate is kept
    assert os.path.exists(cfg_p.TPU.QUANT_SCALES_PATH)


def test_calibration_keys_and_tags_match_jax(calibrated):
    sj, sp = calibrated["scales_j"], calibrated["scales_p"]
    assert set(sp) == set(sj) and len(sp) == 58
    assert all(set(sp[k]) == set(sj[k]) for k in sj)
    assert not any("top_p" in k for k in sp)  # P6/P7 never quantize
    for k in FIRST_SITES:  # no int8 code upstream can differ yet
        for t in sj[k]:
            assert sp[k][t] == pytest.approx(sj[k][t], rel=1e-6), (k, t)
    rel = max(abs(sp[k][t] - sj[k][t]) / sj[k][t] for k in sj for t in sj[k])
    assert rel < 5e-2, rel


def test_port_calibration_covers_the_same_sites_per_batch(calibrated):
    """A running max over batches: two copies of the batch give the same file."""
    cfg = calibrated["cfg"].clone()
    cfg.TPU.QUANT_MIN_CH = 0  # the regime prepare_static_scales calibrates in
    again = capture_scales(cfg, calibrated["pm"], [calibrated["images"]] * 2)
    assert again.keys() == calibrated["scales_p"].keys()
    assert all(again[k] == pytest.approx(calibrated["scales_p"][k], rel=0) for k in again)


def test_jax_scales_file_serves_the_port_and_the_slice_matches(calibrated):
    """One shared scales file (JAX's): no scale misses on the port, equal
    valid sets, sorted scores within 2e-2 (see the module docstring)."""
    cfg_shared = calibrated["cfg_j"].clone()
    infer = get_inference_fn(calibrated["pm"], cfg_shared)
    det_p = {k: v.numpy() for k, v in infer(calibrated["images"], calibrated["intrinsics"]).items()}
    assert infer.quant.misses == []
    det_j = calibrated["det_j"]
    assert set(det_p) == set(det_j)
    np.testing.assert_array_equal(det_p["valid"], det_j["valid"])
    assert det_j["valid"].sum() == 40
    for key in ("scores", "scores_3d"):
        for i in range(2):
            a = np.sort(det_j[key][i][det_j["valid"][i]])
            b = np.sort(det_p[key][i][det_p["valid"][i]])
            np.testing.assert_allclose(b, a, atol=2e-2, err_msg=f"{key} image {i}")
    # the int8 path really ran: fp32 serving gives other scores
    fp32 = get_inference_fn(calibrated["pm"], fp32_cfg())(calibrated["images"], calibrated["intrinsics"])
    assert not np.array_equal(fp32["scores"].numpy(), det_p["scores"])


def test_calibrate_and_predict_clis(tmp_path):
    """`python -m dd3d_tpu_torch.calibrate_int8` writes a scales JSON both
    packages load; `python -m dd3d_tpu_torch.predict` serves with it."""
    import cv2

    rng = np.random.RandomState(0)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        cv2.imwrite(str(imgs / f"{i:06d}.png"), (rng.rand(100, 330, 3) * 255).astype(np.uint8))
    scales = tmp_path / "scales.json"
    env = {**os.environ, "OMP_NUM_THREADS": "2"}  # test files run in parallel processes
    common = ["--experiment", "dd3d_kitti_dla34", "--images", str(imgs), "--intrinsics", "721.5,721.5,609.5,172.8",
              "--device", "cpu", "--batch", "2"]
    cmd = [sys.executable, "-m", "dd3d_tpu_torch.calibrate_int8", *common, "--out", str(scales),
           "INPUT.RESIZE.MIN_SIZE_TEST=128", "TPU.QUANT_MIN_CH=0", "TPU.QUANT_UNFOLDED=True"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    text = scales.read_text()
    assert text.startswith("{\n") and json.loads(text) == load_quant_scales(str(scales))
    assert load_quant_scales(str(scales)) == jax_load_quant_scales(str(scales))
    assert len(json.loads(text)) == 58

    out = tmp_path / "preds.json"
    cmd = [sys.executable, "-m", "dd3d_tpu_torch.predict", *common, "--out", str(out),
           "INPUT.RESIZE.MIN_SIZE_TEST=128", "TPU.QUANT_INT8=True",
           "TPU.QUANT_MIN_CH=32", "TPU.QUANT_UNFOLDED=True", f"TPU.QUANT_SCALES_PATH={scales}"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no calibrated scale" not in proc.stderr
    records = json.loads(out.read_text())
    assert [r["image_id"] for r in records] == ["000000", "000001"] and all(r["scores"] for r in records)
