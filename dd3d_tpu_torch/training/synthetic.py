"""Seeded synthetic training batches in the collate_batch schema
(dd3d_tpu/data/mapper.py::collate_batch), for runs without a dataset: noise
images, and 3D boxes placed in front of the camera whose 2D boxes are the
bounding boxes of their projected corners, so the 2D and 3D targets agree.
`seed_norm_statistics` gives a freshly built model's norms seeded affines
and statistics."""
from typing import Dict

import numpy as np
import torch

from dd3d_tpu_torch.models.layers import FoldableBatchNorm, FrozenBatchNorm

# the corner order of structures/boxes3d.py, in (l, w, h) object axes
_CORNER_SIGNS = np.array([(1, 1, 1), (1, -1, 1), (1, -1, -1), (1, 1, -1),
                          (-1, 1, 1), (-1, -1, 1), (-1, -1, -1), (-1, 1, -1)], np.float64)


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def seed_norm_statistics(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Norm scales 1 + N(0, 0.1), biases and means N(0, 0.1), variances
    U(0.5, 1.5), in place: with build_model's He-initialized convs, features
    and gradients then carry the image through the whole depth."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (FrozenBatchNorm, FoldableBatchNorm)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=generator))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=generator))
    return model


def synthetic_batch(rng: np.random.RandomState, batch: int, height: int, width: int, max_gt: int = 64,
                    num_classes: int = 5, max_gt_per_image: int = 12,
                    depth_density: float = 0.0) -> Dict[str, np.ndarray]:
    """One batch: image (B, H, W, 3) uint8 BGR, intrinsics (B, 3, 3),
    gt_boxes2d (B, G, 4) xyxy, gt_classes (B, G), gt_boxes3d (B, G, 10) as
    [quat wxyz, proj_ctr, depth, size wlh], gt_valid (B, G), image_size
    (B, 2) and color_jitter (B, 3) blend weights; G = max_gt, 1 to
    max_gt_per_image boxes an image. With `depth_density` > 0 also a sparse
    GT `depth` (B, H, W) f32 for DD3DDenseDepth, as a projected lidar scan
    gives it: that share of the pixels holds a depth (0 elsewhere), the
    ground plane's below the horizon (1.65 m under the camera, KITTI's) and
    5-80 m above it, a few of them past MAX_DEPTH (80 m), which the loss
    masks."""
    f = 0.58 * width  # KITTI's focal length relative to its width
    k = np.array([[f, 0.0, width / 2], [0.0, f, height / 2], [0.0, 0.0, 1.0]])
    inv_k = np.linalg.inv(k)
    out = {
        "image": rng.randint(0, 256, (batch, height, width, 3)).astype(np.uint8),
        "intrinsics": np.tile(k.astype(np.float32), (batch, 1, 1)),
        "gt_boxes2d": np.zeros((batch, max_gt, 4), np.float32),
        "gt_classes": np.zeros((batch, max_gt), np.int32),
        "gt_boxes3d": np.zeros((batch, max_gt, 10), np.float32),
        "gt_valid": np.zeros((batch, max_gt), bool),
        "image_size": np.tile(np.array([height, width], np.int32), (batch, 1)),
    }
    for b in range(batch):
        n = min(rng.randint(1, max_gt_per_image + 1), max_gt)
        i = 0
        while i < n:
            u, v = rng.uniform(0.1 * width, 0.9 * width), rng.uniform(0.35 * height, 0.8 * height)
            depth = rng.uniform(6.0, 40.0)
            center = depth * (inv_k @ np.array([u, v, 1.0]))
            size = np.array([rng.uniform(1.4, 2.0), rng.uniform(3.0, 4.6), rng.uniform(1.3, 1.9)])  # w, l, h
            yaw = rng.uniform(-np.pi, np.pi)
            quat = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])  # about the camera's y axis
            half = 0.5 * np.array([size[1], size[0], size[2]])  # wlh -> lwh
            corners = (_CORNER_SIGNS * half) @ _quat_to_matrix(quat).T + center
            if corners[:, 2].min() < 1.0:
                continue
            uv = corners @ k.T
            uv = uv[:, :2] / uv[:, 2:]
            x1, y1 = np.clip(uv.min(0), 0, [width, height])
            x2, y2 = np.clip(uv.max(0), 0, [width, height])
            if x2 - x1 < 4 or y2 - y1 < 4:
                continue
            out["gt_boxes2d"][b, i] = (x1, y1, x2, y2)
            out["gt_classes"][b, i] = rng.randint(0, num_classes)
            out["gt_boxes3d"][b, i] = np.concatenate([quat, [u, v, depth], size])
            out["gt_valid"][b, i] = True
            i += 1
    out["color_jitter"] = rng.uniform(0.8, 1.2, (batch, 3)).astype(np.float32)
    if depth_density > 0:
        out["depth"] = sparse_depth(rng, batch, height, width, f, depth_density)
    return out


def sparse_depth(rng: np.random.RandomState, batch: int, height: int, width: int, focal: float,
                 density: float) -> np.ndarray:
    """(B, H, W) f32 sparse depth, 0 where a pixel has none: see
    `synthetic_batch`."""
    rows = np.arange(height, dtype=np.float64)[:, None] - height / 2
    ground = np.where(rows > 0, 1.65 * focal / np.maximum(rows, 1e-6), np.inf)  # the ground plane's depth a row
    depth = np.where(np.isfinite(ground), np.broadcast_to(ground, (height, width)), 0.0)
    out = np.zeros((batch, height, width), np.float32)
    for b in range(batch):
        hit = rng.rand(height, width) < density
        far = rng.uniform(5.0, 85.0, (height, width))
        out[b] = np.where(hit, np.where(depth > 0, np.minimum(depth, 90.0), far), 0.0)
    return out
