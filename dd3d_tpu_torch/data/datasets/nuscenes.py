"""nuScenes dataset: keyframe camera images -> dataset dicts; the port's
copy of dd3d_tpu/data/datasets/nuscenes.py.

Rebuild of `tridet/data/datasets/nuscenes/build.py`: each item is one camera
image of a keyframe (6 cameras x samples). Per annotation: category remap to
the 10 detection classes, 3D box in the sensor frame, 2D box from projected
corners with visibility filtering, attribute id, speed from box velocity;
ego pose + camera extrinsics as Pose dicts; lidar-point-count filter.

The nuscenes-devkit is an optional dependency: dataset
construction raises a clear error without it, while registration stays cheap
and lazy like the reference's DatasetCatalog thunks.
"""
import logging
import os
from typing import List

import numpy as np

from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from dd3d_tpu_torch.structures.pose import Pose

LOG = logging.getLogger(__name__)

# canonical nuScenes detection classes (build.py category remap)
CLASS_NAMES = (
    "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
)

CATEGORY_REMAP = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

# 3 attributes per group + shared "ignore" id (= MAX_NUM_ATTRIBUTES - 1);
# cf. nuscenes build.py:224-230.
ATTRIBUTE_IDS = {
    "vehicle.moving": 0, "vehicle.parked": 1, "vehicle.stopped": 2,
    "cycle.with_rider": 0, "cycle.without_rider": 1,
    "pedestrian.moving": 0, "pedestrian.standing": 1, "pedestrian.sitting_lying_down": 2,
}
MAX_NUM_ATTRIBUTES = 4

CAMERA_NAMES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT")

DATASET_NAME_TO_VERSION = {
    "nusc_train": ("v1.0-trainval", "train"),
    "nusc_val": ("v1.0-trainval", "val"),
    "nusc_val-subsample-8": ("v1.0-trainval", "val"),
    "nusc_trainval": ("v1.0-trainval", "trainval"),
    "nusc_test": ("v1.0-test", "test"),
    "nusc_mini_train": ("v1.0-mini", "mini_train"),
    "nusc_mini_val": ("v1.0-mini", "mini_val"),
}


def build_nuscenes_dataset(name: str, root_dir: str, min_num_lidar_points: int = 3, min_box_visibility: float = 0.2) -> List[dict]:
    try:
        from nuscenes.nuscenes import NuScenes  # type: ignore
        from nuscenes.utils.splits import create_splits_scenes  # type: ignore
    except ImportError as e:
        raise ImportError(
            "nuscenes-devkit is required to materialize nuScenes datasets; "
            "install it or use the KITTI-3D datasets."
        ) from e

    version, split = DATASET_NAME_TO_VERSION[name]
    nusc = NuScenes(version=version, dataroot=root_dir, verbose=False)
    scene_names = set(create_splits_scenes()[split.replace("trainval", "train")])

    subsample = 8 if name.endswith("subsample-8") else 1

    dicts = []
    sample_idx = 0
    for sample in nusc.sample:
        scene = nusc.get("scene", sample["scene_token"])
        if scene["name"] not in scene_names:
            continue
        sample_idx += 1
        if (sample_idx - 1) % subsample != 0:
            continue
        for cam in CAMERA_NAMES:
            sd = nusc.get("sample_data", sample["data"][cam])
            cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            ego = nusc.get("ego_pose", sd["ego_pose_token"])
            k = np.asarray(cs["camera_intrinsic"], dtype=np.float64)

            pose_world_ego = Pose(wxyz=ego["rotation"], tvec=ego["translation"])
            pose_ego_cam = Pose(wxyz=cs["rotation"], tvec=cs["translation"])
            pose_world_cam = pose_world_ego * pose_ego_cam

            annos = []
            for tok in sample["anns"]:
                ann = nusc.get("sample_annotation", tok)
                if ann["category_name"] not in CATEGORY_REMAP:
                    continue
                if ann["num_lidar_pts"] + ann["num_radar_pts"] < min_num_lidar_points:
                    continue
                cat = CATEGORY_REMAP[ann["category_name"]]
                box_world = Pose(wxyz=ann["rotation"], tvec=ann["translation"])
                box_cam = pose_world_cam.inverse() * box_world
                if box_cam.tvec[2] <= 0:
                    continue
                w, l, h = ann["size"]
                bbox3d = np.concatenate([box_cam.quat, box_cam.tvec, [w, l, h]])
                bbox2d = _project_bbox2d(bbox3d, k, sd["width"], sd["height"])
                if bbox2d is None:
                    continue
                attr_tokens = ann["attribute_tokens"]
                if attr_tokens:
                    attr_name = nusc.get("attribute", attr_tokens[0])["name"]
                    attr_id = ATTRIBUTE_IDS.get(attr_name, MAX_NUM_ATTRIBUTES - 1)
                else:
                    attr_id = MAX_NUM_ATTRIBUTES - 1
                velocity = nusc.box_velocity(tok)
                speed = float(np.linalg.norm(velocity[:2])) if np.isfinite(velocity).all() else 0.0
                annos.append(
                    {
                        "category_id": CLASS_NAMES.index(cat),
                        "instance_id": tok,
                        "bbox": bbox2d,
                        "bbox3d": bbox3d.tolist(),
                        "attribute_id": int(attr_id),
                        "speed": speed,
                    }
                )
            dicts.append(
                {
                    "file_name": os.path.join(root_dir, sd["filename"]),
                    "image_id": sd["token"],
                    "sample_id": sample["token"],
                    "sample_token": sample["token"],
                    "width": sd["width"],
                    "height": sd["height"],
                    "intrinsics": [float(v) for v in k.flatten()],
                    "pose": {"wxyz": pose_world_cam.quat.tolist(), "tvec": pose_world_cam.tvec.tolist()},
                    "extrinsics": {"wxyz": pose_ego_cam.quat.tolist(), "tvec": pose_ego_cam.tvec.tolist()},
                    "annotations": annos,
                }
            )
    return dicts


def _project_bbox2d(bbox3d, k, width, height):
    from dd3d_tpu_torch.data.datasets.kitti_3d import _project_corners_bbox2d

    box = _project_corners_bbox2d(bbox3d, np.asarray(k))
    x1, y1, x2, y2 = box
    cx1, cy1 = max(x1, 0.0), max(y1, 0.0)
    cx2, cy2 = min(x2, float(width)), min(y2, float(height))
    if cx2 <= cx1 or cy2 <= cy1:
        return None
    full = (x2 - x1) * (y2 - y1)
    vis = (cx2 - cx1) * (cy2 - cy1)
    if full <= 0 or vis / full < 0.2:
        return None
    return [cx1, cy1, cx2, cy2]


def register_nuscenes_datasets(cfg) -> List[str]:
    root = os.path.join(cfg.get("DATASET_ROOT", os.environ.get("DATASET_ROOT", "/data/datasets")), "nuscenes")
    names = []
    for name in DATASET_NAME_TO_VERSION:
        DatasetCatalog.register(name, (lambda name=name: build_nuscenes_dataset(name, root)))
        md = MetadataCatalog.get(name)
        md["thing_classes"] = list(CLASS_NAMES)
        md["id_to_name"] = {i: n for i, n in enumerate(CLASS_NAMES)}
        md["evaluators"] = ("nuscenes_evaluator",)
        md["pred_visualizers"] = ("d2_visualizer", "box3d_visualizer")
        md["loader_visualizers"] = ("d2_visualizer", "box3d_visualizer")
        md["root_dir"] = root
        names.append(name)
    return names
