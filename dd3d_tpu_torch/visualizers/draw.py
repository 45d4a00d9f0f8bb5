"""Low-level drawing helpers: 2D boxes with labels, projected 3D boxes, the
BEV canvas, `mosaic` and `save_vis`. The port's counterpart of
dd3d_tpu/visualizers/draw.py, drawing with its own rasterizer
(visualizers/raster.py, equal to cv2 5.0 pixel for pixel) and writing with
its own PNG writer (data/imageio.write_png); no cv2.

Rebuild of `tridet/utils/visualization.py` (mosaic/save_vis/colors) and
`tridet/visualizers/bev.py` (BEVImage).
"""
import os
from typing import List, Optional

import numpy as np

from dd3d_tpu_torch.visualizers import raster

# bright palette like seaborn "bright" (kitti_3d build.py:31-42)
DEFAULT_COLORS = [
    (0, 154, 23), (255, 127, 14), (31, 119, 180), (227, 119, 194),
    (140, 86, 75), (148, 103, 189), (214, 39, 40), (127, 127, 127),
]

# edges of the 8-corner box in our corner order (see models/cross_camera.py)
BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # +x face
    (4, 5), (5, 6), (6, 7), (7, 4),  # -x face
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def draw_boxes2d(image: np.ndarray, boxes: np.ndarray, classes=None, scores=None,
                 class_names=None, colors=DEFAULT_COLORS, thickness=2) -> np.ndarray:
    out = image.copy()
    for i, b in enumerate(np.asarray(boxes).astype(int)):
        color = colors[int(classes[i]) % len(colors)] if classes is not None else colors[0]
        raster.rectangle(out, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), color, thickness)
        label = ""
        if class_names is not None and classes is not None:
            label = class_names[int(classes[i])]
        if scores is not None:
            label += f" {float(scores[i]):.2f}"
        if label:
            raster.put_text(out, label, (int(b[0]), max(int(b[1]) - 4, 10)), color)
    return out


def draw_boxes3d(image: np.ndarray, quats: np.ndarray, tvecs: np.ndarray, sizes: np.ndarray,
                 intrinsics: np.ndarray, classes=None, colors=DEFAULT_COLORS, thickness=2) -> np.ndarray:
    """Project 8 corners and draw wireframes; a box with a corner at depth
    0.1 or less is skipped."""
    from dd3d_tpu_torch.models.cross_camera import _corners_np

    out = image.copy()
    if len(quats) == 0:
        return out
    corners = _corners_np(np.asarray(quats, np.float64), np.asarray(tvecs, np.float64), np.asarray(sizes, np.float64))
    k = np.asarray(intrinsics, np.float64)
    for i in range(len(corners)):
        if corners[i][:, 2].min() <= 0.1:
            continue
        uvw = corners[i] @ k.T
        uv = (uvw[:, :2] / uvw[:, 2:3]).astype(int)
        color = colors[int(classes[i]) % len(colors)] if classes is not None else colors[0]
        for a, b in BOX_EDGES:
            raster.line(out, (int(uv[a][0]), int(uv[a][1])), (int(uv[b][0]), int(uv[b][1])), color, thickness)
    return out


class BEVImage:
    """Bird-eye-view canvas; draws 3D boxes as rotated rectangles.
    cf. tridet/visualizers/bev.py:16."""

    def __init__(self, metric_width: float = 100.0, metric_height: float = 100.0, pixels_per_meter: int = 10):
        self.ppm = pixels_per_meter
        self.w = int(metric_width * pixels_per_meter)
        self.h = int(metric_height * pixels_per_meter)
        self.data = np.full((self.h, self.w, 3), 30, np.uint8)
        # ego at bottom-center; forward (camera z) goes up.
        raster.circle(self.data, (self.w // 2, self.h - 1), 4, (0, 0, 255), -1)

    def render_boxes3d(self, quats, tvecs, sizes, classes=None, colors=DEFAULT_COLORS, thickness=2):
        from dd3d_tpu_torch.models.cross_camera import boxes_to_bev5_np

        if len(quats) == 0:
            return self
        bev5 = boxes_to_bev5_np(np.asarray(quats, np.float64), np.asarray(tvecs, np.float64),
                                np.asarray(sizes, np.float64))
        for i, (cx, cy, bw, bl, ang) in enumerate(bev5):
            # BEV frame: x right, y down-image (forward = -y). Map meters->px.
            px = int(self.w / 2 + cx * self.ppm)
            py = int(self.h + cy * self.ppm)
            color = colors[int(classes[i]) % len(colors)] if classes is not None else colors[0]
            rect = raster.box_points((px, py), (bw * self.ppm, bl * self.ppm), -ang)
            raster.polylines(self.data, rect.astype(np.int32), True, color, thickness)
        return self


def mosaic(images: List[np.ndarray], grid_cols: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """Tile images into a grid (tridet/utils/visualization.py:111)."""
    if not images:
        return np.zeros((1, 1, 3), np.uint8)
    n = len(images)
    cols = grid_cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h = max(im.shape[0] for im in images) + pad
    w = max(im.shape[1] for im in images) + pad
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h: r * h + im.shape[0], c * w: c * w + im.shape[1]] = im
    return canvas


def save_vis(image: np.ndarray, output_dir: str, name: str) -> str:
    """Write `image` (BGR uint8) as `<output_dir>/<name>.png`
    (cf. tridet/utils/visualization.py:25); returns the path."""
    from dd3d_tpu_torch.data.imageio import write_png

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name if name.endswith(".png") else name + ".png")
    write_png(path, np.ascontiguousarray(image))
    return path
