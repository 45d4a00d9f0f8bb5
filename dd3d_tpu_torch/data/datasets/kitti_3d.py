"""KITTI-3D dataset: split/calib/label parsing into dataset dicts; the port's
own copy of dd3d_tpu/data/datasets/kitti_3d.py.

Rebuild of `tridet/data/datasets/kitti_3d/build.py` without pandas/cv2/
pyquaternion dependencies for the math:
- mv3d split files (build.py:56-63),
- calibration: P2/P3 projection matrices decomposed into K + camera pose via
  a numpy RQ decomposition (replaces cv2.decomposeProjectionMatrix,
  build.py:100-157),
- label_2 parsing: KITTI (H, W, L, x, y, z, ry) -> our 10-D box
  [quat wxyz, tvec, size (w, l, h)] with the bottom-center -> cuboid-center
  lift and the quat(x, +90deg) * quat(z, -ry) axis change (build.py:239-266),
- optional 2D-from-3D projected corners (build.py:268-278),
- monocular flattening over sensors (build.py:281-291),
- 8 registered dataset variants incl. the 32-item overfit split
  (kitti_3d/__init__.py:14-25).
"""
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from dd3d_tpu_torch.data.imageio import read_image_size
from dd3d_tpu_torch.structures.pose import Pose, _quat_to_matrix_np

LOG = logging.getLogger(__name__)

VALID_CLASS_NAMES = ("Car", "Pedestrian", "Cyclist", "Van", "Truck")

# All 8 KITTI categories, for visualization metadata (build.py:32-42).
ALL_CLASS_NAMES = ("Car", "Pedestrian", "Cyclist", "Van", "Truck", "Person_sitting", "Tram", "Misc")

MV3D_SPLIT_KITTI_3D_REMAP = {
    "train": "training",
    "val": "training",
    "test": "testing",
    "overfit": "training",
    "trainval": "training",
}


def rq_decomposition(m: np.ndarray):
    """RQ decomposition of a 3x3 matrix: M = R @ Q with R upper-triangular and
    Q orthonormal. Standard QR-of-reversed trick."""
    p = np.fliplr(np.eye(3))
    q_, r_ = np.linalg.qr((p @ m).T)
    r = p @ r_.T @ p
    q = p @ q_.T
    # Fix signs so that diag(R) > 0.
    d = np.diag(np.sign(np.diag(r)))
    return r @ d, d @ q


def decompose_projection_matrix(p: np.ndarray):
    """P (3x4) -> (K, R, t) with P = K [R | t]; same convention as
    cv2.decomposeProjectionMatrix (which returns the camera CENTER; we return
    t directly for pose construction like build.py:125-131)."""
    k, r = rq_decomposition(p[:, :3])
    if np.linalg.det(r) < 0:
        r = -r
        # keep K @ R = P[:, :3]
        k = -k
        d = np.diag(np.sign(np.diag(k)))
        k = k @ d
        r = d @ r
    t = np.linalg.solve(k, p[:, 3])
    k = k / k[2, 2]
    return k, r, t


def _axis_angle_quat(axis, radians):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = radians / 2.0
    return np.concatenate([[np.cos(half)], np.sin(half) * axis])


def _quat_multiply_np(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def read_calibration_file(filename: str):
    """Parse one KITTI calib file -> {(sensor): (K, pose_S0)} where pose_S0
    maps camera-0(world) points into the sensor frame (matching
    `pose_20.inverse()` in build.py:157)."""
    rows = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            parts = line.strip().split()
            if not parts:
                continue
            rows[i] = np.array([float(v) for v in parts[1:]], dtype=np.float64)

    r0_rect = np.eye(4)
    r0_rect[:3, :3] = rows[4].reshape(3, 3)

    out = {}
    for row_idx, cam in ((2, "camera_2"), (3, "camera_3")):
        p = rows[row_idx].reshape(3, 4)
        k, r, t = decompose_projection_matrix(p)
        t_c0 = np.eye(4)
        t_c0[:3, :3] = r
        t_c0[:3, 3] = t
        pose_c0 = Pose.from_matrix(t_c0 @ r0_rect)  # world(cam0) -> cam
        out[cam] = (k.astype(np.float64), pose_c0.inverse())

    t_0v = np.vstack([rows[5].reshape(3, 4), [0, 0, 0, 1]])
    out["velodyne"] = (None, Pose.from_matrix(t_0v))
    return out


def parse_label_file(filename: str, class_names: Sequence[str]):
    """label_2 txt -> list of annotation dicts. Box conversion per
    build.py:239-266; bbox3d = [quat wxyz, tvec(3), size (w, l, h)]."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    annotations = []
    raw_rows = []
    if not os.path.exists(filename):
        return annotations, raw_rows
    with open(filename) as f:
        for idx, line in enumerate(f):
            parts = line.strip().split()
            if not parts:
                continue
            raw_rows.append(parts)
            cls = parts[0]
            if cls not in name_to_id:
                continue
            vals = [float(v) for v in parts[1:]]
            l2d, t2d, r2d, b2d = vals[3:7]
            h, w, l = vals[7:10]
            x, y, z = vals[10:13]
            ry = vals[13]

            quat = _quat_multiply_np(
                _axis_angle_quat([1, 0, 0], np.pi / 2), _axis_angle_quat([0, 0, 1], -ry)
            )
            tvec = np.array([x, y - h / 2.0, z])
            bbox3d = np.concatenate([quat, tvec, [w, l, h]]).astype(np.float64)
            annotations.append(
                {
                    "category_id": name_to_id[cls],
                    "instance_id": f"{os.path.basename(filename).split('.')[0]}_{idx}",
                    "bbox": [l2d, t2d, r2d, b2d],
                    "bbox3d": bbox3d.tolist(),
                    "distance": float(np.linalg.norm(tvec)),
                    "truncation": vals[0],
                    "occlusion": vals[1],
                    "alpha": vals[2],
                }
            )
    return annotations, raw_rows


def _project_corners_bbox2d(bbox3d, k):
    """2D box from projected 3D corners (build.py:268-278)."""
    quat = np.asarray(bbox3d[:4])
    tvec = np.asarray(bbox3d[4:7])
    size = np.asarray(bbox3d[7:])  # (w, l, h)
    lwh = size[[1, 0, 2]]
    signs = np.array(
        [[1, 1, 1], [1, -1, 1], [1, -1, -1], [1, 1, -1], [-1, 1, 1], [-1, -1, 1], [-1, -1, -1], [-1, 1, -1]],
        dtype=np.float64,
    )
    corners_obj = 0.5 * lwh * signs
    r = _quat_to_matrix_np(quat / np.linalg.norm(quat))
    corners = corners_obj @ r.T + tvec
    uvw = corners @ k.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    return [float(uv[:, 0].min()), float(uv[:, 1].min()), float(uv[:, 0].max()), float(uv[:, 1].max())]


def build_monocular_kitti3d_dataset(
    mv3d_split: str,
    root_dir: str,
    class_names: Sequence[str] = VALID_CLASS_NAMES,
    sensors: Sequence[str] = ("camera_2",),
    box2d_from_box3d: bool = False,
    max_num_items: Optional[int] = None,
) -> List[dict]:
    """Materialize the flattened (per-camera-image) dataset dicts."""
    split_file = os.path.join(root_dir, "mv3d_kitti_splits", f"{mv3d_split}.txt")
    with open(split_file) as f:
        split = [line.strip() for line in f if line.strip()]
    if max_num_items is not None:
        split = split[: min(len(split), max_num_items)]

    kitti_split_dir = MV3D_SPLIT_KITTI_3D_REMAP[mv3d_split]
    if sensors != ("camera_2",):
        box2d_from_box3d = True

    dicts = []
    for sample_id in split:
        calib = read_calibration_file(os.path.join(root_dir, kitti_split_dir, "calib", f"{sample_id}.txt"))
        _, pose_0v = calib["velodyne"]
        for sensor in sensors:
            k, pose_s0 = calib[sensor]
            pose_0s = pose_s0.inverse()
            extrinsics = pose_0v.inverse() * pose_0s

            img_dir = "image_2" if sensor == "camera_2" else "image_3"
            file_name = os.path.join(root_dir, kitti_split_dir, img_dir, f"{sample_id}.png")
            width, height = _image_size(file_name)

            annotations, raw_rows = parse_label_file(
                os.path.join(root_dir, kitti_split_dir, "label_2", f"{sample_id}.txt"), class_names
            )
            annos = []
            for a in annotations:
                a = dict(a)
                if sensor != "camera_2":
                    # transform the 3D box into the other camera frame
                    box_pose = Pose(wxyz=a["bbox3d"][:4], tvec=a["bbox3d"][4:7])
                    new_pose = pose_s0 * calib["camera_2"][1].inverse() * box_pose
                    a["bbox3d"] = np.concatenate([new_pose.quat, new_pose.tvec, a["bbox3d"][7:]]).tolist()
                if box2d_from_box3d:
                    a["bbox"] = _project_corners_bbox2d(a["bbox3d"], k)
                annos.append(a)

            dicts.append(
                {
                    "file_name": file_name,
                    "image_id": f"{sample_id}_{sensor}",
                    "sample_id": sample_id,
                    "width": width,
                    "height": height,
                    "intrinsics": [float(v) for v in k.flatten()],
                    "extrinsics": {"wxyz": extrinsics.quat.tolist(), "tvec": extrinsics.tvec.tolist()},
                    "annotations": annos,
                    # full raw label rows (incl. DontCare / real truncation &
                    # occlusion) — the GT side of the KITTI evaluator
                    # (kitti_3d_evaluator.py:137-141).
                    **({"raw_kitti_annotations": raw_rows} if sensor == "camera_2" else {}),
                }
            )
    return dicts


def _image_size(path: str):
    """(width, height), read from the PNG or JPEG header (the JAX package
    opens the file with PIL)."""
    if not os.path.exists(path):
        return 1242, 375  # canonical KITTI size for fixture-less metadata
    height, width = read_image_size(path)
    return width, height


# (name, split, max_num_items, box2d_from_box3d); kitti_3d/__init__.py:14-25.
DATASET_DICTS_BUILDER = {
    "kitti_3d_train": ("train", None, False),
    "kitti_3d_val": ("val", None, False),
    "kitti_3d_trainval": ("trainval", None, False),
    "kitti_3d_test": ("test", None, False),
    "kitti_3d_overfit": ("train", 32, False),
    "kitti_3d_train_project_box3d": ("train", None, True),
    "kitti_3d_val_project_box3d": ("val", None, True),
    "kitti_3d_overfit_project_box3d": ("train", 32, True),
}


def register_kitti_3d_datasets(cfg) -> List[str]:
    root = os.path.join(cfg.get("DATASET_ROOT", os.environ.get("DATASET_ROOT", "/data/datasets")), "KITTI3D")
    names = []
    for name, (split, max_items, box2d_from_3d) in DATASET_DICTS_BUILDER.items():
        DatasetCatalog.register(
            name,
            (lambda split=split, max_items=max_items, b23=box2d_from_3d: build_monocular_kitti3d_dataset(
                split, root, max_num_items=max_items, box2d_from_box3d=b23
            )),
        )
        md = MetadataCatalog.get(name)
        md["thing_classes"] = list(VALID_CLASS_NAMES)
        md["id_to_name"] = {i: n for i, n in enumerate(VALID_CLASS_NAMES)}
        md["evaluators"] = ("coco_evaluator", "kitti3d_evaluator")
        md["pred_visualizers"] = ("d2_visualizer", "box3d_visualizer")
        md["loader_visualizers"] = ("d2_visualizer", "box3d_visualizer")
        md["root_dir"] = root
        names.append(name)
    return names
