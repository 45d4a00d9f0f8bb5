"""The test-time resize of the serving path: the port's own copy of the
inference part of dd3d_tpu/data/augmentations.py.

Only what `predict.iter_batches` needs: ResizeShortestEdge at
INPUT.RESIZE.MIN_SIZE_TEST (fvcore's target arithmetic), the resize of a
uint8 image by PIL's BILINEAR (fvcore's path for uint8 images), and the
intrinsics rescale. Training augmentations (crop, flip, color jitter) are
not copied. cv2 and PIL are imported inside the functions that use them, so
the package imports on a machine that has neither.
"""
from typing import Optional, Tuple

import numpy as np


def resize_shortest_edge_dims(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """Target (new_h, new_w) with fvcore's exact arithmetic
    (fvcore ResizeShortestEdge.get_transform): scale the UNROUNDED float
    dims, clamp to max_size, then round half-up with int(x + 0.5)."""
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        s2 = max_size / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    return int(newh + 0.5), int(neww + 0.5)


class ResizeTransform:
    """Resize an image from (h, w) to (new_h, new_w) and rescale its
    intrinsics to match (dd3d_tpu/data/augmentations.py:56-88)."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        # fvcore's ResizeTransform routes uint8 images through PIL's BILINEAR
        # (antialiased on downscale); cv2's INTER_LINEAR is another kernel.
        # Per-channel resize is channel-order agnostic, so BGR arrays are fine.
        if img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f"need a uint8 (H, W, C) image, got {img.dtype} {img.shape}")
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((self.new_w, self.new_h), Image.BILINEAR))

    def apply_intrinsics(self, k: np.ndarray) -> np.ndarray:
        fx = self.new_w / self.w
        fy = self.new_h / self.h
        return k * np.float64([fx, fy, 1]).reshape(3, 1)


class ResizeShortestEdge:
    """Resize the shortest edge to a size drawn from `short_edge_lengths`
    (sample style "choice", the test-time style), the longest edge capped at
    `max_size`; a drawn size of 0 leaves the image as it is."""

    def __init__(self, short_edge_lengths, max_size: int):
        if isinstance(short_edge_lengths, int):
            short_edge_lengths = [short_edge_lengths]
        self.short_edge_lengths = list(short_edge_lengths)
        self.max_size = max_size

    def get_transform(self, image: np.ndarray, rng: np.random.RandomState) -> Optional[ResizeTransform]:
        h, w = image.shape[:2]
        size = int(rng.choice(self.short_edge_lengths))
        if size == 0:
            return None
        return ResizeTransform(h, w, *resize_shortest_edge_dims(h, w, size, self.max_size))


def build_test_resize(cfg) -> Optional[ResizeShortestEdge]:
    """The inference branch of dd3d_tpu/data/augmentations.py::build_augmentation
    (is_train=False): the test resize, or None."""
    if not cfg.INPUT.AUG_ENABLED or not cfg.INPUT.RESIZE.MIN_SIZE_TEST:
        return None
    return ResizeShortestEdge(cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.INPUT.RESIZE.MAX_SIZE_TEST)
