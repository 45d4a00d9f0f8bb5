"""Dataset mapper: dataset dict -> model-ready numpy sample; the port's own
copy of dd3d_tpu/data/mapper.py, its training and inference branches and
the full `collate_batch`.

Rebuild of `tridet/data/dataset_mappers/dataset_mapper.py` +
`transform_utils.py`:
- read BGR image, apply the augmentation pipeline (intrinsics/box3d aware),
- transform + clip 2D boxes (transform_utils.py:54-63),
- drop boxes with non-positive center depth (dataset_mapper.py:187-189),
- convert GT 3D boxes [quat, tvec, size] into the DECODE parameterization
  [quat_ego, proj_ctr, depth, size] using the FINAL (augmented) intrinsics —
  the equivalent of `Boxes3D.from_vectors(..., intrinsics)` in
  transform_utils.py:114-120,
- filter empty instances in training (d2 filter_empty_instances).

Images are read by the port's own reader (data/imageio.py), byte-identical
to the cv2.imread the JAX package falls back to.
"""
import logging
from typing import List, Optional

import numpy as np

from dd3d_tpu_torch.data.augmentations import Augmentation, ResizeTransform, TransformList, sample_jitter_factors
from dd3d_tpu_torch.data.imageio import read_image_bgr

LOG = logging.getLogger(__name__)


class DatasetMapper:
    def __init__(self, augmentations: List[Augmentation], is_train: bool, box3d_on: bool = True,
                 nuscenes: bool = False, device_jitter_cfg=None, depth_on: bool = True):
        self.augmentations = augmentations
        self.is_train = is_train
        self.box3d_on = box3d_on
        # Task gating (TaskManager): drop dense-depth GT when the depth task
        # is off, cf. tridet dataset_mapper.py:167-177.
        self.depth_on = depth_on
        self.nuscenes = nuscenes
        # When set, color jitter runs on-device: sample the blend weights here
        # and let the compiled step apply them (ops/color_jitter.py).
        self.device_jitter_cfg = device_jitter_cfg

    def __call__(self, dataset_dict: dict, rng: Optional[np.random.RandomState] = None,
                 fixed_transforms: Optional[list] = None,
                 preresized: Optional[tuple] = None) -> dict:
        """preresized, when given, is (resized_bgr_image, (src_h, src_w)) from
        the loader's batched decode+resize (data/imageio.decode_resize_batch).
        The transform list is still drawn from `rng`
        exactly as without it — only a shape proxy stands in for the decoded
        image — so the augmentation seed stream and all geometry handling are
        byte-identical to the per-image path (tests/test_torch_loader.py).
        If the drawn transforms don't match what the loader pre-applied (it
        guarantees resize-first), the image is decoded from disk as usual."""
        rng = rng or np.random.RandomState()
        if preresized is not None:
            # get_transform implementations only read image.shape
            image = np.broadcast_to(np.zeros((), np.uint8), (*preresized[1], 3))
        else:
            image = read_image_bgr(dataset_dict["file_name"])

        annos = dataset_dict.get("annotations", [])
        boxes2d = np.asarray([a["bbox"] for a in annos], dtype=np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in annos], dtype=np.int32)
        boxes3d = (
            np.asarray([a["bbox3d"] for a in annos], dtype=np.float64).reshape(-1, 10)
            if self.box3d_on and annos and "bbox3d" in annos[0]
            else np.zeros((len(annos), 10))
        )
        attributes = np.asarray([a.get("attribute_id", 0) for a in annos], dtype=np.int32)
        speeds = np.asarray([a.get("speed", 0.0) for a in annos], dtype=np.float32)

        sample = {
            "image": image,
            "intrinsics": np.asarray(dataset_dict["intrinsics"], dtype=np.float64).reshape(3, 3),
            "boxes2d": boxes2d,
            "boxes3d": boxes3d,
        }

        if fixed_transforms is not None:
            tfms = TransformList(fixed_transforms)
        else:
            tfms = TransformList([aug.get_transform(sample["image"], rng) for aug in self.augmentations])
        if preresized is not None:
            img, (src_h, src_w) = preresized
            t0 = tfms.tfms[0] if tfms.tfms else None
            if (isinstance(t0, ResizeTransform) and (t0.h, t0.w) == (src_h, src_w)
                    and (t0.new_h, t0.new_w) == img.shape[:2]):
                sample = t0(sample, skip_image=True)
                sample["image"] = img
                for t in tfms.tfms[1:]:
                    sample = t(sample)
            else:
                # drawn transforms disagree with the pre-applied resize
                # (e.g. crop enabled): decode from disk and run normally
                sample["image"] = read_image_bgr(dataset_dict["file_name"])
                sample = tfms(sample)
        else:
            sample = tfms(sample)

        h, w = sample["image"].shape[:2]
        boxes2d = sample["boxes2d"]
        if len(boxes2d):
            # Clip to image (transform_utils.py:54-63).
            boxes2d[:, 0::2] = np.clip(boxes2d[:, 0::2], 0, w)
            boxes2d[:, 1::2] = np.clip(boxes2d[:, 1::2], 0, h)

        keep = np.ones(len(classes), dtype=bool)
        if self.box3d_on and len(classes):
            keep &= sample["boxes3d"][:, 6] > 0  # positive center depth
        if self.is_train and len(classes):
            keep &= (boxes2d[:, 2] > boxes2d[:, 0]) & (boxes2d[:, 3] > boxes2d[:, 1])

        k = sample["intrinsics"].astype(np.float64)
        boxes3d_t = sample["boxes3d"][keep]
        quat = boxes3d_t[:, :4]
        tvec = boxes3d_t[:, 4:7]
        size = boxes3d_t[:, 7:]
        uvw = tvec @ k.T
        proj_ctr = uvw[:, :2] / np.maximum(np.abs(uvw[:, 2:3]), 1e-9) * np.sign(uvw[:, 2:3] + 1e-30)
        depth = tvec[:, 2:3]
        gt_boxes3d = np.concatenate([quat, proj_ctr, depth, size], axis=1).astype(np.float32)

        out = {
            # Keep the image in its native dtype (uint8 from the reader): the
            # host->device transfer is 4x smaller and the model's
            # normalization promotes to float on device.
            "image": np.ascontiguousarray(sample["image"]),
            "intrinsics": k.astype(np.float32),
            "gt_boxes2d": boxes2d[keep].astype(np.float32),
            "gt_classes": classes[keep],
            "gt_boxes3d": gt_boxes3d,
            "width": dataset_dict.get("width", w),
            "height": dataset_dict.get("height", h),
            "image_id": dataset_dict.get("image_id"),
            "sample_id": dataset_dict.get("sample_id"),
            "image_size": np.asarray([h, w], dtype=np.int32),
        }
        if self.device_jitter_cfg is not None and self.is_train:
            out["color_jitter"] = sample_jitter_factors(self.device_jitter_cfg, rng)
        if self.nuscenes:
            out["gt_attributes"] = attributes[keep]
            out["gt_speeds"] = speeds[keep]
            if "pose" in dataset_dict:
                out["pose"] = dataset_dict["pose"]
        if "extrinsics" in dataset_dict:
            out["extrinsics"] = dataset_dict["extrinsics"]
        if self.depth_on and sample.get("depth") is not None:
            out["depth"] = sample["depth"].astype(np.float32)
        return out


def pad_to_divisibility(h: int, w: int, divisibility: int):
    pad = lambda v: int(np.ceil(v / divisibility) * divisibility)  # noqa: E731
    return pad(h), pad(w)


def collate_batch(samples: List[dict], max_gt: int, size_divisibility: int = 128,
                  want_depth: bool = None, want_pose: bool = None, canvas_hw=None) -> dict:
    """Static-shape batch: images padded bottom-right to a common canvas
    rounded to `size_divisibility` (cf. ImageList.from_tensors,
    tridet/structures/image_list.py:124-127), GT padded to `max_gt`.

    `want_depth`/`want_pose` make the batch's KEY SET config-derived rather
    than data-derived: a data-dependent pytree structure means a fresh XLA
    compile whenever presence flips between batches and, in multi-host runs
    (independent sample streams per process), divergent compiled programs
    that hang the gradient all-reduce. `canvas_hw` similarly pins the padded
    canvas for multi-host runs where the local batch's max dims may differ
    per process."""
    max_h = max(s["image"].shape[0] for s in samples)
    max_w = max(s["image"].shape[1] for s in samples)
    if canvas_hw is not None:
        max_h, max_w = max(max_h, canvas_hw[0]), max(max_w, canvas_hw[1])
    ph, pw = pad_to_divisibility(max_h, max_w, size_divisibility)

    b = len(samples)
    images = np.zeros((b, ph, pw, 3), dtype=samples[0]["image"].dtype)
    intrinsics = np.zeros((b, 3, 3), dtype=np.float32)
    gt_boxes2d = np.zeros((b, max_gt, 4), dtype=np.float32)
    gt_classes = np.zeros((b, max_gt), dtype=np.int32)
    gt_boxes3d = np.zeros((b, max_gt, 10), dtype=np.float32)
    gt_valid = np.zeros((b, max_gt), dtype=bool)
    image_sizes = np.zeros((b, 2), dtype=np.int32)
    has_nusc = "gt_attributes" in samples[0]
    gt_attributes = np.zeros((b, max_gt), dtype=np.int32)
    gt_speeds = np.zeros((b, max_gt), dtype=np.float32)
    has_jitter = "color_jitter" in samples[0]
    color_jitter = np.ones((b, 3), dtype=np.float32)
    # Camera->global poses as device arrays: needed by the in-graph
    # cross-camera sample aggregation (ops/sample_bev_nms.py). Presence is
    # config-derived when the caller says so (see docstring); the data-
    # derived fallback covers the whole batch, not samples[0], so a mixed
    # batch can't KeyError or silently drop GT. Missing poses fall back to
    # identity; missing depth maps stay all-zero, which the dense-depth
    # loss masks out (depth <= 0 is invalid, dense_depth_loss.py:28-36).
    has_pose = want_pose if want_pose is not None else any(s.get("pose") is not None for s in samples)
    pose_quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (b, 1))
    pose_tvec = np.zeros((b, 3), dtype=np.float32)
    has_depth = want_depth if want_depth is not None else any(s.get("depth") is not None for s in samples)
    depth = np.zeros((b, ph, pw), dtype=np.float32) if has_depth else None

    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[i, :h, :w] = s["image"]
        intrinsics[i] = s["intrinsics"]
        n = min(len(s["gt_classes"]), max_gt)
        if len(s["gt_classes"]) > max_gt:
            LOG.warning(
                "Sample %s has %d GT boxes; truncating to %d", s.get("image_id"), len(s["gt_classes"]), max_gt
            )
        gt_boxes2d[i, :n] = s["gt_boxes2d"][:n]
        gt_classes[i, :n] = s["gt_classes"][:n]
        gt_boxes3d[i, :n] = s["gt_boxes3d"][:n]
        gt_valid[i, :n] = True
        image_sizes[i] = s["image_size"]
        if has_nusc:
            gt_attributes[i, :n] = s["gt_attributes"][:n]
            gt_speeds[i, :n] = s["gt_speeds"][:n]
        if has_jitter:
            color_jitter[i] = s["color_jitter"]
        if has_pose and s.get("pose") is not None:
            p = s["pose"]
            pose_quat[i] = np.asarray(p["wxyz"], np.float32)
            pose_tvec[i] = np.asarray(p["tvec"], np.float32)
        if has_depth and s.get("depth") is not None:
            dh, dw = s["depth"].shape[:2]
            depth[i, :dh, :dw] = s["depth"]

    batch = {
        "image": images,
        "intrinsics": intrinsics,
        "gt_boxes2d": gt_boxes2d,
        "gt_classes": gt_classes,
        "gt_boxes3d": gt_boxes3d,
        "gt_valid": gt_valid,
        "image_size": image_sizes,
    }
    if has_nusc:
        batch["gt_attributes"] = gt_attributes
        batch["gt_speeds"] = gt_speeds
    if has_jitter:
        batch["color_jitter"] = color_jitter
    if has_pose:
        batch["pose_quat"] = pose_quat
        batch["pose_tvec"] = pose_tvec
    if has_depth:
        batch["depth"] = depth
    meta = [
        {k: s.get(k) for k in ("image_id", "sample_id", "width", "height", "pose", "extrinsics")}
        for s in samples
    ]
    return batch, meta
