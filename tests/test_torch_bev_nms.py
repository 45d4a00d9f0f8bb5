"""The port's rotated BEV NMS paths against the JAX package's, on the CPU, on
the same seeded detection dicts:

- `models/dd3d._bev_nms_in_graph` (the per-image DO_BEV_NMS) and
  `ops/sample_bev_nms.sample_bev_nms_in_graph` (a sample of 6 cameras, one
  global NMS, at most 500 kept) against JAX's: the same `valid` masks, the
  scores zeroed at the same places, global quat / tvec within 1e-4;
- `models/cross_camera.greedy_rotated_nms_np`, `get_group_idxs` and
  `nuscenes_sample_aggregate` (the host path of the TTA test) against
  JAX's: the same kept indices and per-image dicts, global boxes within
  1e-9 (both f64).

The detections are drawn in clusters so that suppression has work, and
redrawn until no BEV IoU lies within 1e-4 of the threshold (the two f32
IoUs differ by rounding only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg as jax_get_experiment_cfg
from dd3d_tpu.models import cross_camera as jcc
from dd3d_tpu.models.dd3d import _bev_nms_in_graph as jax_bev_nms_in_graph
from dd3d_tpu.ops.sample_bev_nms import sample_bev_nms_in_graph as jax_sample_bev_nms
from dd3d_tpu.structures.pose import Pose as JaxPose
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import cross_camera as pcc
from dd3d_tpu_torch.models.dd3d import _bev_nms_in_graph
from dd3d_tpu_torch.ops.geometry import unproject_points2d
from dd3d_tpu_torch.ops.rotated_boxes import boxes3d_corners_to_bev_boxes, pairwise_rotated_iou
from dd3d_tpu_torch.ops.sample_bev_nms import sample_bev_nms_in_graph
from dd3d_tpu_torch.structures.boxes3d import generic_corners
from dd3d_tpu_torch.structures.pose import Pose
from tests.torch_port_util import torch_threads

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):  # test files run in parallel processes
        yield


K = np.float32([[300.0, 0.0, 200.0], [0.0, 300.0, 100.0], [0.0, 0.0, 1.0]])
THR = 0.3  # the nuScenes experiments' BEV_NMS_IOU_THRESH


def detections(rng, b: int, d: int, num_classes: int = 3) -> dict:
    """(b, d) padded detections in clusters of near-duplicates."""
    centers = rng.rand(b, 8, 2) * [400, 200]
    pick = rng.randint(0, 8, (b, d))
    proj_ctr = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(b, d, 2) * 3
    depth = 10 + np.take_along_axis(rng.rand(b, 8) * 30, pick, 1)[..., None] + rng.randn(b, d, 1) * 0.3
    quat = rng.randn(b, d, 4) * 0.05 + [np.sqrt(0.5), np.sqrt(0.5), 0, 0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    size = np.abs(rng.randn(b, d, 3) * 0.2 + [1.8, 4.5, 1.6])
    scores = rng.rand(b, d)
    valid = rng.rand(b, d) > 0.1
    det = {
        "boxes2d": rng.rand(b, d, 4) * 100, "scores": np.where(valid, scores * 0.9, 0.0),
        "scores_3d": np.where(valid, scores, 0.0), "classes": rng.randint(0, num_classes, (b, d)),
        "fpn_levels": rng.randint(0, 5, (b, d)), "valid": valid, "boxes3d_quat": quat,
        "boxes3d_proj_ctr": proj_ctr, "boxes3d_depth": depth, "boxes3d_size": size, "conf3d": rng.rand(b, d),
    }
    return {k: v.astype(np.int32) if v.dtype.kind == "i" else v if v.dtype == bool else v.astype(np.float32)
            for k, v in det.items()}


def bev_iou_far_from(det, intrinsics, thr) -> bool:
    """No BEV IoU of an image's detections within 1e-4 of `thr`."""
    tensors = {k: torch.from_numpy(v) for k, v in det.items()}
    tvec = unproject_points2d(tensors["boxes3d_proj_ctr"], torch.linalg.inv(torch.from_numpy(intrinsics)))
    tvec = tvec * tensors["boxes3d_depth"]
    bev = boxes3d_corners_to_bev_boxes(generic_corners(tensors["boxes3d_quat"], tvec, tensors["boxes3d_size"]))
    iou = pairwise_rotated_iou(bev, bev).numpy()
    return not np.any(np.abs(iou - thr) < 1e-4)


def per_image_case(seed):
    rng = np.random.RandomState(seed)
    intrinsics = np.stack([K, K * np.float32([[1.1], [1.1], [1]])])
    while True:
        det = detections(rng, 2, 100)
        if bev_iou_far_from(det, intrinsics, THR):
            return det, intrinsics


@pytest.mark.parametrize("seed", [0, 1])
def test_bev_nms_in_graph_matches_jax(seed):
    det, intrinsics = per_image_case(seed)
    cfg, jcfg = get_experiment_cfg("dd3d_nusc_dla34"), jax_get_experiment_cfg("dd3d_nusc_dla34")
    assert cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH == jcfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH
    cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH = jcfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH = THR
    got = _bev_nms_in_graph(cfg, {k: torch.from_numpy(v) for k, v in det.items()}, torch.from_numpy(intrinsics))
    want = jax_bev_nms_in_graph(jcfg, {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(intrinsics))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert 0 < int(got["valid"].sum()) < int(det["valid"].sum())  # clusters: some suppressed, some kept
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def sample_case(seed, samples=2, cams=6, d=40):
    """`samples` samples of `cams` cameras, each camera its own pose."""
    rng = np.random.RandomState(seed)
    det = detections(rng, samples * cams, d)
    det = {k: v.reshape((samples, cams) + v.shape[1:]) for k, v in det.items()}
    intrinsics = np.broadcast_to(K, (samples, cams, 3, 3)).astype(np.float32).copy()
    yaw = rng.rand(samples, cams) * 0.2  # small turns: neighbouring cameras see the same boxes
    pose_quat = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2), 0 * yaw], -1).astype(np.float32)
    pose_tvec = (rng.randn(samples, cams, 3) * 0.5 + [100, -50, 2]).astype(np.float32)
    return det, intrinsics, pose_quat, pose_tvec


@pytest.mark.parametrize("max_dets", [500, 30])
def test_sample_bev_nms_matches_jax(max_dets):
    det, intrinsics, pq, pt = sample_case(2)
    got = sample_bev_nms_in_graph({k: torch.from_numpy(v) for k, v in det.items()}, torch.from_numpy(intrinsics),
                                  torch.from_numpy(pq), torch.from_numpy(pt), THR, max_dets=max_dets)
    for s in range(2):
        want = jax_sample_bev_nms({k: jnp.asarray(v[s]) for k, v in det.items()}, jnp.asarray(intrinsics[s]),
                                  jnp.asarray(pq[s]), jnp.asarray(pt[s]), THR, max_dets=max_dets)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["valid"][s].numpy(), np.asarray(want["valid"]))
        kept = int(got["valid"][s].sum())
        assert 0 < kept < int(det["valid"][s].sum()) and kept <= max_dets
        np.testing.assert_array_equal(got["scores_3d"][s].numpy(), np.asarray(want["scores_3d"]))
        for k in ("quat_global", "tvec_global"):
            np.testing.assert_allclose(got[k][s].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)


def unpacked(seed, n_images=6, cams=6):
    """Per-image host detections (variable length) with poses, as
    unpack_detections gives them, and each image's camera -> global pose."""
    rng = np.random.RandomState(seed)
    dets, poses = [], []
    for i in range(n_images):
        n = [0, 5, 40][i % 3] if i else 30
        quat = rng.randn(n, 4) * 0.05 + [np.sqrt(0.5), np.sqrt(0.5), 0, 0]
        tvec = np.concatenate([rng.randn(n, 2) * 3, 15 + rng.rand(n, 1) * 10], 1)
        dets.append({"image_id": f"im{i}", "sample_id": f"s{i // cams}", "classes": rng.randint(0, 3, n),
                     "scores": rng.rand(n), "scores_3d": rng.rand(n), "boxes2d": rng.rand(n, 4) * 50,
                     "quat": quat / np.linalg.norm(quat, axis=1, keepdims=True), "tvec": tvec,
                     "size": np.abs(rng.randn(n, 3) * 0.2 + [1.8, 4.5, 1.6]), "attributes": rng.randint(0, 4, n),
                     "speeds": rng.rand(n) * 5})
        yaw = (i % cams) * 0.05
        poses.append(((np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0), (10.0, -2.0, 1.5)))
    return dets, poses


def test_greedy_rotated_nms_np_matches_jax():
    dets, _ = unpacked(5)
    d = dets[0]
    bev = pcc.boxes_to_bev5_np(d["quat"], d["tvec"], d["size"])
    np.testing.assert_array_equal(bev, jcc.boxes_to_bev5_np(d["quat"], d["tvec"], d["size"]))
    got = pcc.greedy_rotated_nms_np(bev, d["scores_3d"], d["classes"], THR)
    want = jcc.greedy_rotated_nms_np(bev, d["scores_3d"], d["classes"], THR)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(d["classes"])


def test_get_group_idxs_matches_jax():
    tokens = ["a", "b", "a", "b", "a", "b"]
    assert pcc.get_group_idxs(tokens, 3) == jcc.get_group_idxs(tokens, 3) == {"a": [0, 2, 4], "b": [1, 3, 5]}
    with pytest.raises(ValueError, match="Group sizes"):
        pcc.get_group_idxs(tokens[:5], 3)


@pytest.mark.parametrize("max_dets", [500, 20])
def test_nuscenes_sample_aggregate_matches_jax(max_dets):
    dets, poses = unpacked(6, n_images=12)
    tokens = [d["sample_id"] for d in dets]
    got = pcc.nuscenes_sample_aggregate(dets, pcc.get_group_idxs(tokens, 6), 3, [Pose(*p) for p in poses], THR,
                                        max_num_dets_per_sample=max_dets)
    want = jcc.nuscenes_sample_aggregate(dets, jcc.get_group_idxs(tokens, 6), 3, [JaxPose(*p) for p in poses],
                                         THR, max_num_dets_per_sample=max_dets)
    assert len(got) == len(want) == 12
    total_in = sum(len(d["classes"]) for d in dets)
    assert sum(len(g["classes"]) for g in got) < total_in
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("quat_global", "tvec_global"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9, err_msg=k)
            elif isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k]
