"""Dataset dict -> padded inference batch: the port's own copy of the
inference path of dd3d_tpu/data/mapper.py.

`DatasetMapper` is the inference branch of the JAX package's mapper with no
annotations (read BGR, test resize, intrinsics rescaled); `collate_batch`
pads images bottom-right to a canvas rounded to the size divisibility and
gives the same keys, dtypes and padding as the JAX package's collate of
such samples (the GT keys all zero, `gt_valid` all False). The JAX package
decodes with its native C++ decoder where it can; that decoder is held
byte-identical to the cv2/PIL path used here (tests/test_native_imageio.py)
and is not copied.
"""
from typing import List, Optional

import numpy as np

from dd3d_tpu_torch.data.augmentations import ResizeShortestEdge


def read_image_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv2.imread(path, IMREAD_COLOR)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


class DatasetMapper:
    """Inference mapper: `resize` is the test resize
    (data/augmentations.build_test_resize), or None."""

    def __init__(self, resize: Optional[ResizeShortestEdge]):
        self.resize = resize

    def __call__(self, dataset_dict: dict, rng: Optional[np.random.RandomState] = None) -> dict:
        rng = rng or np.random.RandomState()
        image = read_image_bgr(dataset_dict["file_name"])
        k = np.asarray(dataset_dict["intrinsics"], dtype=np.float64).reshape(3, 3)
        t = self.resize.get_transform(image, rng) if self.resize is not None else None
        if t is not None:
            image, k = t.apply_image(image), t.apply_intrinsics(k)
        h, w = image.shape[:2]
        return {
            "image": np.ascontiguousarray(image),
            "intrinsics": k.astype(np.float32),
            "width": dataset_dict.get("width", w),
            "height": dataset_dict.get("height", h),
            "image_id": dataset_dict.get("image_id"),
            "sample_id": dataset_dict.get("sample_id"),
            "image_size": np.asarray([h, w], dtype=np.int32),
            **({"extrinsics": dataset_dict["extrinsics"]} if "extrinsics" in dataset_dict else {}),
        }


def pad_to_divisibility(h: int, w: int, divisibility: int):
    pad = lambda v: int(np.ceil(v / divisibility) * divisibility)  # noqa: E731
    return pad(h), pad(w)


def collate_batch(samples: List[dict], max_gt: int, size_divisibility: int = 128):
    """(batch, meta): images padded bottom-right with zeros to a common canvas
    rounded to `size_divisibility`, and GT padding of `max_gt` rows (the
    mapped samples carry no annotations)."""
    max_h = max(s["image"].shape[0] for s in samples)
    max_w = max(s["image"].shape[1] for s in samples)
    ph, pw = pad_to_divisibility(max_h, max_w, size_divisibility)
    b = len(samples)
    images = np.zeros((b, ph, pw, 3), dtype=samples[0]["image"].dtype)
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        images[i, :h, :w] = s["image"]
    batch = {
        "image": images,
        "intrinsics": np.stack([s["intrinsics"] for s in samples]).astype(np.float32),
        "gt_boxes2d": np.zeros((b, max_gt, 4), dtype=np.float32),
        "gt_classes": np.zeros((b, max_gt), dtype=np.int32),
        "gt_boxes3d": np.zeros((b, max_gt, 10), dtype=np.float32),
        "gt_valid": np.zeros((b, max_gt), dtype=bool),
        "image_size": np.stack([s["image_size"] for s in samples]).astype(np.int32),
    }
    meta = [{k: s.get(k) for k in ("image_id", "sample_id", "width", "height", "pose", "extrinsics")}
            for s in samples]
    return batch, meta
