"""The port's nuScenes serving against the plain reference of
tests/torch_ref_nusc.py, on the CPU in f32: dd3d_nusc_dla34 with seeded
random weights on a 128x256 canvas, two samples of six cameras with
nuScenes intrinsics and seeded rig poses, through the port's own entry
`get_inference_fn(model, cfg, group_size=6)`.

- Per image, before the sample walk (`infer(images, intrinsics)`) and after
  it: the same valid count, and scores, 2D boxes, 3D boxes, attributes and
  speeds within rounding.
- Per sample, the global walk's kept set equal wherever the reference's
  decision is firm (the same at the BEV threshold -+ 1e-3), and global
  boxes within 1e-4.
- The reference's rotated IoU against closed forms, and the sample walk's
  cap of 500 in the reference and in the port.
"""
import math

import numpy as np
import pytest
import torch

from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.postprocess import get_inference_fn
from dd3d_tpu_torch.ops.sample_bev_nms import sample_bev_nms_in_graph
from dd3d_tpu_torch.utils.convert_checkpoint import reference_to_port_names
from tests import torch_ref_nusc as ref
from tests.torch_port_util import condition_for_detection, torch_threads
from tests.torch_ref_dd3d import randomize_state

H, W, CAMERAS, SAMPLES = 128, 256, 6, 2
SCALE = H / 900.0  # nuScenes' 900x1600 frames resized to a short side of 128
# nuScenes v1.0 calibrated intrinsics (fx, cx, cy) of FRONT, FRONT_RIGHT, FRONT_LEFT, BACK, BACK_LEFT, BACK_RIGHT
CAMS = ((1266.42, 816.27, 491.51), (1260.85, 807.97, 495.33), (1272.60, 826.62, 479.75),
        (809.22, 829.22, 481.78), (1256.74, 792.11, 492.78), (1259.51, 807.25, 501.20))
YAWS = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
CAM_AXES = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])  # camera axes in a vehicle's


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def yaw_quat(deg):
    return np.array([math.cos(math.radians(deg) / 2), 0.0, 0.0, math.sin(math.radians(deg) / 2)])


AXES_QUAT = np.array([0.5, -0.5, 0.5, -0.5])  # the rotation of CAM_AXES


def rig(rng):
    """(intrinsics (12, 3, 3), pose_quat (12, 4), pose_tvec (12, 3)): camera -> global."""
    ks, qs, ts = [], [], []
    for _ in range(SAMPLES):
        ego_q, ego_t = yaw_quat(rng.uniform(-180, 180)), np.r_[rng.uniform(-40, 40, 2), 0.0]
        for (f, cx, cy), yaw in zip(CAMS, YAWS):
            ks.append(np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]]) * [[SCALE], [SCALE], [1]])
            cam_q = quat_mul(yaw_quat(yaw), AXES_QUAT)
            mount = np.array([1.5 * math.cos(math.radians(yaw)), 1.5 * math.sin(math.radians(yaw)), 1.5])
            qs.append(quat_mul(ego_q, cam_q))
            ts.append(ref.quat_to_rot(torch.as_tensor(ego_q)).numpy() @ mount + ego_t)
    return np.float32(ks), np.float32(qs), np.float32(ts)


def frames(rng, n):
    """Frames with structure at several scales (noise alone averages out)."""
    field = sum(w * torch.nn.functional.interpolate(torch.rand(n, 3, H // c, W // c, generator=rng), size=(H, W),
                                                    mode="bilinear", align_corners=False)
                for c, w in ((32, 0.5), (8, 0.3), (1, 0.2)))
    return ((0.5 + 2.0 * (field - 0.5)) * 255).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def decode_settings(cfg):
    inf2d = cfg.DD3D.FCOS2D.INFERENCE
    return {"num_classes": cfg.DD3D.NUM_CLASSES, "strides": (8, 16, 32, 64, 128), "PRE_NMS_THRESH": inf2d.PRE_NMS_THRESH,
            "PRE_NMS_CANDIDATES_PER_LEVEL": cfg.TPU.PRE_NMS_CANDIDATES_PER_LEVEL, "NMS_CANDIDATES": 512,
            "NMS_THRESH": inf2d.NMS_THRESH, "POST_NMS_TOPK": inf2d.POST_NMS_TOPK,
            "MIN_DEPTH": cfg.DD3D.FCOS3D.MIN_DEPTH, "MAX_DEPTH": cfg.DD3D.FCOS3D.MAX_DEPTH,
            "CANONICAL_BOX3D_SIZES": cfg.DD3D.FCOS3D.CANONICAL_BOX3D_SIZES,
            "BEV_NMS_IOU_THRESH": cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH}


def state_dict(seed):
    model = ref.TorchNuscenesDD3D()
    randomize_state(model, seed=seed)
    sd = condition_for_detection({k: v.numpy().copy() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(seed)
    for name, out in (("attr_logits", 4), ("speed", 1)):  # the other predictors' scale
        sd[f"{name}.weight"] = (rng.randn(out, 256, 3, 3) * 1e-5).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(out) * 0.1 + (0.5 if name == "speed" else 0.0)).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def served():
    with torch_threads():
        cfg = get_experiment_cfg("dd3d_nusc_dla34")
        cfg.TPU.COMPUTE_DTYPE = "float32"
        model = build_model(cfg)
        sd = state_dict(11)
        model.load_state_dict(reference_to_port_names(sd, model), strict=True)
        reference = ref.TorchNuscenesDD3D()
        reference.load_state_dict(sd)
        reference.eval()
        rng = np.random.default_rng(5)
        images = frames(torch.Generator().manual_seed(5), SAMPLES * CAMERAS)
        k, pq, pt = rig(rng)
        infer = get_inference_fn(model, cfg, group_size=CAMERAS)
        per_image = {key: v.numpy() for key, v in infer(images, k).items()}
        aggregated = {key: v.numpy() for key, v in infer(images, k, pq, pt).items()}
        with torch.no_grad():
            outputs = reference(torch.as_tensor(images).permute(0, 3, 1, 2).float())
        dec = decode_settings(cfg)
        samples = [ref.serve_sample(outputs, s * CAMERAS, CAMERAS, torch.as_tensor(k), pq, pt, dec)
                   for s in range(SAMPLES)]
        yield per_image, aggregated, [d for s in samples for d in s], dec


def served_image(det, i, mask=None):
    sel = np.nonzero(det["valid"][i] if mask is None else mask)[0]
    return {k: v[i][sel] for k, v in det.items()}


def assert_same_image(got, want):
    assert len(got["classes"]) == len(want["cls"]) > 0
    np.testing.assert_array_equal(got["classes"], want["cls"])
    np.testing.assert_allclose(got["scores_3d"], want["score3d"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["scores"], want["score"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["boxes2d"], want["box"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["boxes3d_depth"][:, 0], want["depth"], rtol=1e-4)
    np.testing.assert_allclose(got["boxes3d_proj_ctr"], want["proj_ctr"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["boxes3d_size"], want["size"], rtol=1e-4, atol=1e-6)
    rot = ref.quat_to_rot(torch.as_tensor(got["boxes3d_quat"], dtype=torch.float64)).numpy()
    np.testing.assert_allclose(rot, want["rot"], atol=1e-4)
    np.testing.assert_array_equal(got["attributes"], want["attr"])
    np.testing.assert_allclose(got["speeds"], want["speed"], rtol=1e-4, atol=1e-5)


def test_each_image_before_the_sample_walk(served):
    per_image, _, images, _ = served
    for i, want in enumerate(images):
        assert_same_image(served_image(per_image, i), want)


def test_each_image_after_the_sample_walk(served):
    _, aggregated, images, _ = served
    for i, want in enumerate(images):
        assert_same_image(served_image(aggregated, i), {k: v[want["kept"]] for k, v in want.items()})


def test_the_sample_walk_agrees_on_firm_decisions_and_suppresses(served):
    per_image, aggregated, images, dec = served
    t = dec["BEV_NMS_IOU_THRESH"]
    suppressed = 0
    for s in range(SAMPLES):
        dets = images[s * CAMERAS:(s + 1) * CAMERAS]
        lo, _, _ = ref.sample_walk(dets, t - 1e-3)
        hi, _, _ = ref.sample_walk(dets, t + 1e-3)
        for c, det in enumerate(dets):
            i = s * CAMERAS + c
            before = np.nonzero(per_image["valid"][i])[0]
            got = aggregated["valid"][i][before]
            firm = (lo[c] == det["kept"]) & (hi[c] == det["kept"])
            np.testing.assert_array_equal(got[firm], det["kept"][firm])
            suppressed += int((~det["kept"]).sum())
    assert suppressed > 0  # the walk has work at this size: boxes of two cameras overlap


def test_global_boxes(served):
    _, aggregated, images, _ = served
    for i, want in enumerate(images):
        got = served_image(aggregated, i, aggregated["valid"][i])
        rot = ref.quat_to_rot(torch.as_tensor(got["quat_global"], dtype=torch.float64)).numpy()
        np.testing.assert_allclose(rot, want["rot_g"][want["kept"]], atol=1e-4)
        np.testing.assert_allclose(got["tvec_global"], want["tvec_g"][want["kept"]], rtol=1e-4, atol=1e-4)


def box(cx, cy, w, l, a):
    return np.array([[cx, cy, w, l, a]], np.float64)


@pytest.mark.parametrize("a, b, want", [
    (box(1, 2, 2, 4, 30), box(1, 2, 2, 4, 30), 1.0),  # identical
    (box(0, 0, 2, 4, 10), box(10, 0, 2, 4, 70), 0.0),  # disjoint
    (box(0, 0, 2, 4, 0), box(1, 1, 2, 4, 0), (1 * 3) / (8 + 8 - 3)),  # axis-aligned: a 1 x 3 overlap
    (box(3, -1, 2, 6, 25), box(3, -1, 2, 6, 115), 2 / (2 * 6 - 2)),  # turned 90 degrees about its centre: 2 x 2
    (box(0, 0, 2, 2, 0), box(0, 0, 2, 2, 45), (8 * (math.sqrt(2) - 1)) / (8 - 8 * (math.sqrt(2) - 1))),  # octagon
])
def test_rotated_iou_closed_forms(a, b, want):
    assert ref.rotated_iou(a, b)[0, 0] == pytest.approx(want, abs=1e-12)
    assert ref.rotated_iou(b, a)[0, 0] == pytest.approx(want, abs=1e-12)


def test_the_sample_walk_keeps_at_most_500():
    """600 disjoint boxes of one class over six cameras: the reference's walk
    and the port's sample NMS keep the 500 best."""
    rng = np.random.default_rng(0)
    n = 100
    score = rng.permutation(CAMERAS * n).reshape(CAMERAS, n) / (CAMERAS * n) + 0.01
    tvec = np.stack([np.arange(CAMERAS * n) * 10.0, np.zeros(CAMERAS * n), np.full(CAMERAS * n, 20.0)], 1)
    tvec = tvec.reshape(CAMERAS, n, 3)
    rot = np.broadcast_to(np.eye(3), (CAMERAS, n, 3, 3))
    dets = [{"score3d": score[c], "cls": np.zeros(n, int), "rot_g": rot[c], "tvec_g": tvec[c],
             "size": np.tile([1.8, 4.5, 1.6], (n, 1))} for c in range(CAMERAS)]
    masks, _, _ = ref.sample_walk(dets, 0.3)
    kept = np.concatenate(masks)
    assert kept.sum() == 500 and set(np.argsort(-score.reshape(-1))[:500]) == set(np.nonzero(kept)[0])
    k = torch.tensor([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]]).expand(1, CAMERAS, 3, 3)
    u = 50.0 + 50.0 * torch.arange(n, dtype=torch.float32)  # 10 m apart at 20 m: x = 10 i
    det = {"valid": torch.ones(1, CAMERAS, n, dtype=torch.bool),
           "scores_3d": torch.as_tensor(score, dtype=torch.float32)[None],
           "classes": torch.zeros(1, CAMERAS, n, dtype=torch.int64),
           "boxes3d_quat": torch.tensor([1.0, 0, 0, 0]).expand(1, CAMERAS, n, 4),
           "boxes3d_proj_ctr": torch.stack([u, torch.full_like(u, 50.0)], -1).expand(1, CAMERAS, n, 2),
           "boxes3d_depth": torch.full((1, CAMERAS, n, 1), 20.0),
           "boxes3d_size": torch.tensor([1.8, 4.5, 1.6]).expand(1, CAMERAS, n, 3)}
    pose_t = torch.zeros(1, CAMERAS, 3)
    pose_t[0, :, 0] = torch.arange(CAMERAS) * n * 10.0  # each camera's boxes past the last one's
    out = sample_bev_nms_in_graph(det, k, torch.tensor([1.0, 0, 0, 0]).expand(1, CAMERAS, 4), pose_t, 0.3)
    assert int(out["valid"].sum()) == 500
    np.testing.assert_array_equal(out["valid"][0].reshape(-1).numpy(), kept)
