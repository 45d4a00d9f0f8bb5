"""Host-side numpy augmentations with intrinsics / 3D-box / depth awareness:
the port's own copy of dd3d_tpu/data/augmentations.py, its test and
training halves.

Rebuild of `tridet/data/augmentations/` (fvcore Transform extensions):
- ResizeShortestEdge: rescales fx, fy, cx, cy (resize_transform.py:13-21) and
  sparse-preserving depth resize (resize_transform.py:31-71),
- RandomCrop: shifts cx, cy (crop_transform.py:8-18),
- RandomFlip (horizontal): mirrors image/boxes, reflects cx
  (flip_transform.py:8-10), and mirrors the quaternion as
  [w,x,y,z] -> [z, -y, -x, w] with tvec.x negated (flip_transform.py:28-54),
- ColorJitter (brightness/saturation/contrast): d2 blend semantics; no-op on
  geometry (color_transform.py:10-25).

Each transform is a dict-in/dict-out callable over a mutable "sample" with
keys: image (H, W, 3 uint8/float BGR), intrinsics (3, 3), boxes2d (N, 4),
boxes3d (N, 10), depth (H, W) optional.

The resize of a uint8 image is the port's PIL-exact bilinear resize
(data/imageio.py); the JAX package's cv2.INTER_LINEAR branch for float
images is not ported (the mapper feeds uint8 images only) and raises.
"""
from typing import List, Sequence

import numpy as np

from dd3d_tpu_torch.data.imageio import resize_bilinear


class Transform:
    def apply_image(self, img):
        return img

    def apply_boxes2d(self, boxes):
        return boxes

    def apply_intrinsics(self, k):
        return k

    def apply_boxes3d(self, boxes3d):
        return boxes3d

    def apply_depth(self, depth):
        return depth

    def __call__(self, sample: dict, skip_image: bool = False) -> dict:
        # skip_image: apply only the geometry/annotation handlers — the
        # loader's fused native decode+resize already produced the image
        # (mapper `preresized` fast path).
        if not skip_image:
            sample["image"] = self.apply_image(sample["image"])
        if "intrinsics" in sample:
            sample["intrinsics"] = self.apply_intrinsics(sample["intrinsics"])
        if "boxes2d" in sample and len(sample["boxes2d"]):
            sample["boxes2d"] = self.apply_boxes2d(sample["boxes2d"])
        if "boxes3d" in sample and len(sample["boxes3d"]):
            sample["boxes3d"] = self.apply_boxes3d(sample["boxes3d"])
        if "depth" in sample and sample["depth"] is not None:
            sample["depth"] = self.apply_depth(sample["depth"])
        return sample


class ResizeTransform(Transform):
    def __init__(self, h, w, new_h, new_w):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img):
        # fvcore's ResizeTransform routes uint8 images through PIL's
        # BILINEAR (antialiased on downscale since Pillow 9) — cv2's
        # INTER_LINEAR uses a different kernel, which would shift pixel
        # values and therefore AP vs the reference. Per-channel resize is
        # channel-order agnostic, so BGR arrays are fine.
        if img.dtype != np.uint8 or img.ndim != 3:
            raise NotImplementedError(f"resize of a {img.dtype} {img.shape} image is not ported; "
                                      "the port resizes uint8 (H, W, C) images")
        return resize_bilinear(img, self.new_h, self.new_w)

    def apply_boxes2d(self, boxes):
        fx = self.new_w / self.w
        fy = self.new_h / self.h
        return boxes * np.array([fx, fy, fx, fy], dtype=boxes.dtype)

    def apply_intrinsics(self, k):
        fx = self.new_w / self.w
        fy = self.new_h / self.h
        return k * np.float64([fx, fy, 1]).reshape(3, 1)

    def apply_depth(self, depth):
        # Sparse-preserving resize (resize_transform.py:31-71).
        h, w = depth.shape
        x = depth.reshape(-1)
        uv = np.mgrid[:h, :w].transpose(1, 2, 0).reshape(-1, 2)
        idx = x > 0
        crd, val = uv[idx], x[idx]
        crd = crd.astype(np.float64)
        crd[:, 0] = (crd[:, 0] * (self.new_h / h)).astype(np.int32)
        crd[:, 1] = (crd[:, 1] * (self.new_w / w)).astype(np.int32)
        crd = crd.astype(np.int32)
        keep = (crd[:, 0] < self.new_h) & (crd[:, 1] < self.new_w)
        crd, val = crd[keep], val[keep]
        out = np.zeros((self.new_h, self.new_w), dtype=depth.dtype)
        out[crd[:, 0], crd[:, 1]] = val
        return out


class HFlipTransform(Transform):
    def __init__(self, width):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_boxes2d(self, boxes):
        out = boxes.copy()
        out[:, 0] = self.width - boxes[:, 2]
        out[:, 2] = self.width - boxes[:, 0]
        return out

    def apply_intrinsics(self, k):
        k = k.copy()
        k[0, 2] = self.width - k[0, 2]
        return k

    def apply_boxes3d(self, boxes3d):
        out = boxes3d.copy()
        q = boxes3d[:, :4]
        # [w, x, y, z] -> [z, -y, -x, w]; assumes y=0-plane symmetry
        # (flip_transform.py:28-54).
        out[:, 0] = q[:, 3]
        out[:, 1] = -q[:, 2]
        out[:, 2] = -q[:, 1]
        out[:, 3] = q[:, 0]
        out[:, 4] = -boxes3d[:, 4]  # tvec.x
        return out

    def apply_depth(self, depth):
        return np.ascontiguousarray(depth[:, ::-1])


class CropTransform(Transform):
    def __init__(self, x0, y0, w, h):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h

    def apply_image(self, img):
        return img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]

    def apply_boxes2d(self, boxes):
        return boxes - np.array([self.x0, self.y0, self.x0, self.y0], dtype=boxes.dtype)

    def apply_intrinsics(self, k):
        k = k.copy()
        k[0, 2] -= self.x0
        k[1, 2] -= self.y0
        return k

    def apply_depth(self, depth):
        return depth[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]


class BlendTransform(Transform):
    """d2 color jitter: out = src_weight * src + dst_weight * img."""

    def __init__(self, src, src_weight, dst_weight):
        self.src, self.src_weight, self.dst_weight = src, src_weight, dst_weight

    def apply_image(self, img):
        out = self.src_weight * self.src + self.dst_weight * img.astype(np.float32)
        return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


class NoOpTransform(Transform):
    pass


class TransformList:
    def __init__(self, tfms: Sequence[Transform]):
        self.tfms = list(tfms)

    def __call__(self, sample: dict) -> dict:
        for t in self.tfms:
            sample = t(sample)
        return sample


# ---------------------------------------------------------------------------
# Augmentations (random policy -> Transform)
# ---------------------------------------------------------------------------

class Augmentation:
    def get_transform(self, image, rng) -> Transform:
        raise NotImplementedError


def resize_shortest_edge_dims(h: int, w: int, size: int, max_size: int):
    """Target (new_h, new_w) with fvcore's exact arithmetic
    (fvcore ResizeShortestEdge.get_transform): scale the UNROUNDED float
    dims, clamp to max_size, then round half-up with int(x + 0.5) — python
    round() is banker's rounding and plain int() truncates, either of which
    shifts the target by one pixel vs the reference on .5 boundaries or
    clamped sizes."""
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        s2 = max_size / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    return int(newh + 0.5), int(neww + 0.5)


class ResizeShortestEdge(Augmentation):
    def __init__(self, short_edge_lengths, max_size, sample_style="choice"):
        if isinstance(short_edge_lengths, int):
            short_edge_lengths = [short_edge_lengths]
        self.short_edge_lengths = list(short_edge_lengths)
        self.max_size = max_size
        self.sample_style = sample_style

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        if self.sample_style == "choice":
            size = int(rng.choice(self.short_edge_lengths))
        else:
            size = int(rng.randint(min(self.short_edge_lengths), max(self.short_edge_lengths) + 1))
        if size == 0:
            return NoOpTransform()
        new_h, new_w = resize_shortest_edge_dims(h, w, size, self.max_size)
        return ResizeTransform(h, w, new_h, new_w)


class RandomFlip(Augmentation):
    def __init__(self, prob=0.5):
        self.prob = prob

    def get_transform(self, image, rng):
        if rng.rand() < self.prob:
            return HFlipTransform(image.shape[1])
        return NoOpTransform()


class RandomCrop(Augmentation):
    def __init__(self, crop_type="relative_range", crop_size=(0.9, 0.9)):
        self.crop_type = crop_type
        self.crop_size = crop_size

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        if self.crop_type == "relative":
            ch, cw = int(h * self.crop_size[0]), int(w * self.crop_size[1])
        elif self.crop_type == "relative_range":
            lo = np.asarray(self.crop_size, dtype=np.float64)
            frac = lo + rng.rand(2) * (1 - lo)
            ch, cw = int(h * frac[0]), int(w * frac[1])
        elif self.crop_type == "absolute":
            ch, cw = min(h, int(self.crop_size[0])), min(w, int(self.crop_size[1]))
        else:
            raise NotImplementedError(self.crop_type)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return CropTransform(x0, y0, cw, ch)


class RandomBrightness(Augmentation):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def get_transform(self, image, rng):
        w = rng.uniform(self.lo, self.hi)
        return BlendTransform(np.float32(0.0), 1 - w, w)


class RandomContrast(Augmentation):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def get_transform(self, image, rng):
        w = rng.uniform(self.lo, self.hi)
        return _LazyBlend(lambda img: img.mean(), w)


class RandomSaturation(Augmentation):
    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    def get_transform(self, image, rng):
        w = rng.uniform(self.lo, self.hi)
        # grayscale via BGR weights (d2 uses RGB order; ours is BGR).
        return _LazyBlend(lambda img: img.astype(np.float32) @ np.float32([0.114, 0.587, 0.299])[:, None], w)


class _LazyBlend(Transform):
    """Blend against a function of the image itself (contrast/saturation)."""

    def __init__(self, src_fn, w):
        self.src_fn = src_fn
        self.w = w

    def apply_image(self, img):
        src = self.src_fn(img)
        out = (1 - self.w) * np.asarray(src, dtype=np.float32) + self.w * img.astype(np.float32)
        return np.clip(out, 0, 255).astype(img.dtype) if img.dtype == np.uint8 else out


def build_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    """cf. tridet/data/augmentations/build.py:15-60."""
    if not cfg.INPUT.AUG_ENABLED:
        return []
    augs: List[Augmentation] = []
    if cfg.INPUT.CROP.ENABLED and is_train:
        augs.append(RandomCrop(cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE))
    if is_train:
        min_size = cfg.INPUT.RESIZE.MIN_SIZE_TRAIN
        max_size = cfg.INPUT.RESIZE.MAX_SIZE_TRAIN
        sample_style = cfg.INPUT.RESIZE.MIN_SIZE_TRAIN_SAMPLING
    else:
        min_size = cfg.INPUT.RESIZE.MIN_SIZE_TEST
        max_size = cfg.INPUT.RESIZE.MAX_SIZE_TEST
        sample_style = "choice"
    if min_size:
        augs.append(ResizeShortestEdge(min_size, max_size, sample_style))
    if cfg.INPUT.RANDOM_FLIP.ENABLED and is_train:
        augs.append(RandomFlip())
    if cfg.INPUT.COLOR_JITTER.ENABLED and is_train and not cfg.INPUT.COLOR_JITTER.get("ON_DEVICE", True):
        # Host-side jitter (reference behavior). With ON_DEVICE (default) the
        # mapper only samples blend weights and the compiled train step
        # applies them (ops/color_jitter.py) — ~24 ms/image of host CPU saved.
        b_lo, b_hi = cfg.INPUT.COLOR_JITTER.BRIGHTNESS
        augs.append(RandomBrightness(1 - b_lo, 1 + b_hi))
        s_lo, s_hi = cfg.INPUT.COLOR_JITTER.SATURATION
        augs.append(RandomSaturation(1 - s_lo, 1 + s_hi))
        c_lo, c_hi = cfg.INPUT.COLOR_JITTER.CONTRAST
        augs.append(RandomContrast(1 - c_lo, 1 + c_hi))
    return augs


def sample_jitter_factors(cfg, rng) -> "np.ndarray":
    """Blend weights for device-side jitter; weight 1 == identity."""
    b_lo, b_hi = cfg.INPUT.COLOR_JITTER.BRIGHTNESS
    s_lo, s_hi = cfg.INPUT.COLOR_JITTER.SATURATION
    c_lo, c_hi = cfg.INPUT.COLOR_JITTER.CONTRAST
    return np.asarray(
        [
            rng.uniform(1 - b_lo, 1 + b_hi),
            rng.uniform(1 - s_lo, 1 + s_hi),
            rng.uniform(1 - c_lo, 1 + c_hi),
        ],
        dtype=np.float32,
    )
