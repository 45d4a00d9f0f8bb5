"""The port's decode (`dd3d_inference`: blocked top-k, 3D decode, the
top-512 cap with one packed gather, class-aware NMS, stable compaction)
against dd3d_tpu/models/dd3d.py::dd3d_inference on the same random head
outputs, in the style of tests/test_decode_oracle.py with the 3D head added.

Keep sets, classes and order must be equal exactly. Every field at valid
rows is within 1e-5 (absolute and relative): the decode is the same fp32
arithmetic on both sides, and sigmoid, sqrt, norms and the 3x3 products may
differ by an ulp or two between XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg
from dd3d_tpu.models.dd3d import dd3d_inference as jax_inference
from dd3d_tpu.structures.boxes3d import Boxes3D as JaxBoxes3D
from dd3d_tpu_torch.models.dd3d import dd3d_inference
from dd3d_tpu_torch.structures.boxes3d import Boxes3D

STRIDES = (8, 16, 32, 64, 128)
# A 256x512 canvas: P3 alone has 32*64*5 = 10240 scores (blocked top-k with
# blocks of 6) and the five levels give 978 candidates (over the 512 cap).
SHAPES = [(32, 64), (16, 32), (8, 16), (4, 8), (2, 4)]
KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


def _head_outputs(seed, b, c):
    rng = np.random.RandomState(seed)

    def level(h, w, ch, scale=1.0, shift=0.0):
        return (rng.randn(b, h, w, ch) * scale + shift).astype(np.float32)

    out = {
        # offset so a moderate number of candidates clear the 0.05 threshold
        "logits": [level(h, w, c, 2, -2) for h, w in SHAPES],
        "box2d_reg": [np.abs(level(h, w, 4, 20)) for h, w in SHAPES],
        "centerness": [level(h, w, 1) for h, w in SHAPES],
        "quat": [level(h, w, 4 * c) for h, w in SHAPES],
        "proj_ctr": [level(h, w, 2 * c, 4) for h, w in SHAPES],
        "depth": [level(h, w, c, 5, 20) for h, w in SHAPES],
        "size": [level(h, w, 3 * c, 0.5) for h, w in SHAPES],
        "conf": [level(h, w, c) for h, w in SHAPES],
    }
    intrinsics = np.stack([KITTI_K, KITTI_K * np.array([[1.1], [1.1], [1]], np.float32)])[:b]
    return out, intrinsics


def _decode_both(cfg, seed=0):
    b, c = 2, cfg.DD3D.NUM_CLASSES
    out, intrinsics = _head_outputs(seed, b, c)
    det_j = jax.jit(lambda o, k: jax_inference(cfg, o, k, strides=STRIDES))(
        jax.tree_util.tree_map(jnp.asarray, out), jnp.asarray(intrinsics))
    det_j = {k: np.asarray(v) for k, v in det_j.items()}
    det_p = dd3d_inference(cfg, {k: [torch.from_numpy(x) for x in v] for k, v in out.items()},
                           torch.from_numpy(intrinsics), STRIDES)
    return {k: v.numpy() for k, v in det_p.items()}, det_j, intrinsics


@pytest.mark.parametrize("approx_topk,pre_nms_thresh", [(True, 0.05), (False, 0.05), (True, 0.7)])
def test_decode_matches_jax(approx_topk, pre_nms_thresh):
    """At 0.05 every image fills its 100 detections; at 0.7 fewer survive,
    so the compaction leaves invalid rows."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.USE_APPROX_TOPK = approx_topk
    cfg.DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH = pre_nms_thresh
    det_p, det_j, _ = _decode_both(cfg)
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.sum() > 20 and valid.all() == (pre_nms_thresh == 0.05)
    for key in ("classes", "fpn_levels"):
        np.testing.assert_array_equal(det_p[key][valid], det_j[key][valid], err_msg=key)
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-5, atol=1e-5, err_msg=key)
        assert det_p[key].shape == det_j[key].shape and det_p[key].dtype.kind == det_j[key].dtype.kind, key


def test_decode_options_match_jax():
    """The config switches of the 3D decode at their non-default values:
    distance instead of depth, egocentric quats, no focal-length depth
    scaling, half-stride locations."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.DD3D.FCOS3D.PREDICT_DISTANCE = True
    cfg.DD3D.FCOS3D.PREDICT_ALLOCENTRIC_ROT = False
    cfg.DD3D.FCOS3D.SCALE_DEPTH_BY_FOCAL_LENGTHS = False
    cfg.DD3D.FEATURE_LOCATIONS_OFFSET = "half"
    det_p, det_j, _ = _decode_both(cfg, seed=2)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    np.testing.assert_array_equal(det_p["classes"][valid], det_j["classes"][valid])
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-5, atol=1e-5, err_msg=key)


def test_decode_2d_only_and_no_nms():
    """BOX3D_ON=False (intrinsics unused) and DO_NMS=False (score order only)."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.MODEL.BOX3D_ON = False
    cfg.DD3D.INFERENCE.DO_NMS = False
    det_p, det_j, _ = _decode_both(cfg, seed=1)
    assert set(det_p) == set(det_j) == {"boxes2d", "scores", "classes", "fpn_levels", "valid"}
    np.testing.assert_array_equal(det_p["valid"], det_j["valid"])
    np.testing.assert_array_equal(det_p["classes"], det_j["classes"])
    np.testing.assert_allclose(det_p["scores"], det_j["scores"], rtol=1e-5, atol=1e-5)


def test_boxes3d_container_matches_jax():
    """tvec / corners / vectorize of the decoded boxes, against the JAX container."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    det_p, _det_j, intrinsics = _decode_both(cfg)
    inv_k = np.broadcast_to(np.linalg.inv(intrinsics)[:, None], det_p["boxes3d_quat"].shape[:2] + (3, 3))
    fields = [det_p[k] for k in ("boxes3d_quat", "boxes3d_proj_ctr", "boxes3d_depth", "boxes3d_size")]
    bp = Boxes3D(*(torch.from_numpy(np.ascontiguousarray(f)) for f in fields + [inv_k.astype(np.float32)]))
    bj = JaxBoxes3D(*(jnp.asarray(f) for f in fields + [inv_k.astype(np.float32)]))
    for name in ("tvec", "corners"):
        np.testing.assert_allclose(getattr(bp, name).numpy(), np.asarray(getattr(bj, name)), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(bp.vectorize().numpy(), np.asarray(bj.vectorize()), rtol=1e-5, atol=1e-4)


def test_bev_nms_is_not_ported():
    """With DD3D.INFERENCE.DO_BEV_NMS the decode ends in the per-image BEV NMS
    (models/dd3d._bev_nms_in_graph), which keeps the same detections as
    JAX's, every field within 1e-5 as above, and cuts some of the plain
    decode's."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    plain_p, _, _ = _decode_both(cfg)
    cfg.DD3D.INFERENCE.DO_BEV_NMS = True
    det_p, det_j, _ = _decode_both(cfg)
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert 20 < valid.sum() < plain_p["valid"].sum() and not (valid & ~plain_p["valid"]).any()
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-5, atol=1e-5, err_msg=key)
