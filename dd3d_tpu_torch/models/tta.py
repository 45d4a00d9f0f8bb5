"""Test-time augmentation: the port's counterpart of dd3d_tpu/models/tta.py
(a rebuild of `tridet/modeling/dd3d/test_time_augmentation.py`):
- multi-scale (+ hflip) variants of each image with transformed intrinsics
  (DatasetMapperTTA, :24-85): the shortest edge to each TEST.AUG.MIN_SIZES,
  capped by MAX_SIZE; the uint8 resize is the port's Pillow-exact
  ResizeTransform, the intrinsics are transformed in f64;
- one forward + decode per padded-canvas bucket: every (image, variant)
  instance whose resized image pads to the same (ph, pw) joins one batch, on
  a uint8 zero canvas as the test loader builds it (the model normalizes
  inside, so the padding is -mean/std, as on the JAX package's f32 zero
  canvas); per-variant NMS is off (DO_NMS and DO_BEV_NMS, :82-83);
- the 2D boxes back to the original resolution (unpack_detections) and
  unflipped; quaternion and tvec unflipped by the training flip's involution
  (quat [w,x,y,z] -> [z,-y,-x,w], tvec.x negated);
- the union merged per image on the host in numpy by a class-aware greedy
  NMS (np.argsort(-scores_3d), as in JAX: an unstable sort, kept for its
  order of ties) and POST_NMS_TOPK (:152-183).

Static int8 (TPU.QUANT_INT8): each canvas bucket is calibrated on its first
batch, before that bucket's first forward, with `capture_scales` at
QUANT_MIN_CH=0; the calibrations merge as a running max per (conv path,
shape tag), seeded from TPU.QUANT_SCALES_PATH when it is set
(dd3d_tpu/models/tta.py:88-113, 203-205, 254-279). The merged scales stay in
memory, in the QuantSpec of the inference function (JAX writes a temp file
and bumps its mtime so a re-trace reloads it; eager PyTorch has nothing to
re-trace). Like JAX, only a bucket's first batch calibrates it.

A bucket runs as one forward, as in JAX: a chunk of 80 KITTI frames
(TEST.IMS_PER_BATCH of dd3d_kitti_dla34) puts 160 instances, one scale with
its flip, into each of five buckets up to 640x1920, whose bf16 forward
peaks at 21.2 GiB on an H100 (PERF.md). Calibration, too, runs over the
bucket's whole first batch: it quantizes with dynamic per-tensor scales,
maxima over the batch, so a split batch would calibrate other downstream
maxima.

The rotated BEV NMS over the merge (DO_BEV_NMS) and NuscenesDD3DWithTTA are
not ported (ROADMAP §1 items 7 and 9): they raise.
"""
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

from dd3d_tpu_torch.data.augmentations import HFlipTransform, ResizeTransform

# Each instance's canvas is padded to a multiple of this, as the test loader
# pads its batches (data/build.py): the largest stride of the FPN, p7's.
CANVAS_DIVISIBILITY = 128
DET_KEYS = ("classes", "scores", "scores_3d", "boxes2d", "quat", "tvec", "size", "conf3d")


def _flip_boxes3d_np(quat, tvec):
    q = quat.copy()
    out_q = np.stack([q[:, 3], -q[:, 2], -q[:, 1], q[:, 0]], axis=1)
    out_t = tvec.copy()
    out_t[:, 0] = -out_t[:, 0]
    return out_q, out_t


def _np_greedy_nms_classaware(boxes, scores, classes, thresh):
    """Greedy class-aware NMS over a precomputed IoU matrix (suppress at
    IoU > thresh); the kept indices in score order."""
    order = np.argsort(-scores)
    b = boxes[order]
    c = classes[order]
    n = len(order)
    if n == 0:
        return order
    x1 = np.maximum(b[:, None, 0], b[None, :, 0])
    y1 = np.maximum(b[:, None, 1], b[None, :, 1])
    x2 = np.minimum(b[:, None, 2], b[None, :, 2])
    y2 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)
    suppress = (iou > thresh) & (c[:, None] == c[None, :])
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~suppress[i, i + 1:]
    return order[keep]


class DD3DWithTTA:
    """Multi-scale + flip TTA around the port's inference function
    (models/postprocess.get_inference_fn), on the model's device.

    `stats` holds, over all calls: the instances of each canvas bucket
    ("buckets"), the calibrated buckets ("calibrated", in order), and the
    host seconds of each part ("seconds": "prepare" the resize and canvas,
    "calibrate", "forward" the forward, decode and fetch of the
    detections, "merge" the unpacking, unflip and merged NMS).
    The variants are those of cfg.TEST.AUG (MIN_SIZES, MAX_SIZE, FLIP).
    `int8_plain` runs the int8 kernels' plain versions, calibration
    included, for checking the kernels on the card."""

    def __init__(self, cfg, model, int8_plain: bool = False):
        from dd3d_tpu_torch.models.layers import load_quant_scales
        from dd3d_tpu_torch.models.postprocess import get_inference_fn

        if cfg.MODEL.META_ARCHITECTURE == "NuscenesDD3D":
            raise NotImplementedError("NuscenesDD3DWithTTA: nuScenes TTA and its sample aggregation are not ported "
                                      "(ROADMAP §1 item 9)")
        if cfg.DD3D.INFERENCE.DO_BEV_NMS:
            raise NotImplementedError("DD3D.INFERENCE.DO_BEV_NMS: the rotated BEV NMS over the TTA merge is not "
                                      "ported (ROADMAP §1 item 7)")
        self.cfg = cfg
        self.model = getattr(model, "module", model)
        self.min_sizes = list(cfg.TEST.AUG.MIN_SIZES)
        self.max_size = cfg.TEST.AUG.MAX_SIZE
        self.flip = cfg.TEST.AUG.FLIP
        self.nms_thresh = cfg.DD3D.FCOS2D.INFERENCE.NMS_THRESH
        self.post_nms_topk = cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
        self.int8_plain = int8_plain

        # Per-variant NMS is off; the merged union is suppressed instead, like
        # the reference (postprocess_in_inference=False, train.py:205-207).
        variant_cfg = cfg.clone()
        variant_cfg.DD3D.INFERENCE.DO_NMS = False
        variant_cfg.DD3D.INFERENCE.DO_BEV_NMS = False
        self._quant_int8 = bool(cfg.TPU.get("QUANT_INT8", False))
        self._scales: Dict[str, Dict[str, float]] = {}
        if self._quant_int8:
            base = cfg.TPU.get("QUANT_SCALES_PATH", "") or ""
            self._scales = {p: dict(e) for p, e in (load_quant_scales(base) if base else {}).items()}
            variant_cfg.TPU.QUANT_SCALES_PATH = ""
        self._variant_cfg = variant_cfg
        self._infer = get_inference_fn(self.model, variant_cfg, int8_plain=int8_plain)
        self._infer.quant.scales = self._scales  # the spec reads the merged scales, which calibration grows
        self.stats = {"buckets": defaultdict(int), "calibrated": [], "seconds": defaultdict(float)}

    @property
    def quant(self):
        """The QuantSpec of the forwards (its `misses` list static-scale misses)."""
        return self._infer.quant

    @property
    def scales(self) -> Dict[str, Dict[str, float]]:
        """The merged static int8 scales {conv path: {shape tag: amax}}."""
        return self._scales

    def _variants_hw(self, h: int, w: int):
        for size in self.min_sizes:
            scale = size / min(h, w)
            nh, nw = (size, int(round(scale * w))) if h < w else (int(round(scale * h)), size)
            if max(nh, nw) > self.max_size:
                s2 = self.max_size / max(nh, nw)
                nh, nw = int(nh * s2), int(nw * s2)
            for flipped in ([False, True] if self.flip else [False]):
                yield nh, nw, flipped

    def bucket_layout(self, sizes) -> Dict[tuple, List[tuple]]:
        """{(ph, pw): [(image index, h, w, nh, nw, flipped), ...]} for images
        of `sizes` [(h, w), ...], in the order the buckets are run."""
        buckets: Dict[tuple, List[tuple]] = {}
        d = CANVAS_DIVISIBILITY
        for i, (h, w) in enumerate(sizes):
            for nh, nw, flipped in self._variants_hw(h, w):
                ph, pw = int(np.ceil(nh / d) * d), int(np.ceil(nw / d) * d)
                buckets.setdefault((ph, pw), []).append((i, h, w, nh, nw, flipped))
        return buckets

    def infer_batch(self, images: List[np.ndarray], intrinsics_list: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Merged detections of each (H, W, 3) uint8 BGR image: 2D boxes in
        its original resolution, 3D boxes in its camera frame. One forward
        per canvas bucket."""
        from dd3d_tpu_torch.models.postprocess import unpack_detections

        merged = [{k: [] for k in DET_KEYS} for _ in images]
        seconds = self.stats["seconds"]
        for (ph, pw), insts in self.bucket_layout([im.shape[:2] for im in images]).items():
            t0 = time.perf_counter()
            canvas = np.zeros((len(insts), ph, pw, 3), np.uint8)
            ks = np.zeros((len(insts), 3, 3), np.float32)
            for bi, (i, h, w, nh, nw, flipped) in enumerate(insts):
                tfms = [ResizeTransform(h, w, nh, nw)] + ([HFlipTransform(nw)] if flipped else [])
                sample = {"image": images[i], "intrinsics": np.asarray(intrinsics_list[i], np.float64),
                          "boxes2d": np.zeros((0, 4), np.float32), "boxes3d": np.zeros((0, 10))}
                for t in tfms:
                    sample = t(sample)
                canvas[bi, :nh, :nw] = sample["image"]
                ks[bi] = sample["intrinsics"].astype(np.float32)
            self.stats["buckets"][(ph, pw)] += len(insts)
            t1 = time.perf_counter()
            seconds["prepare"] += t1 - t0

            if self._quant_int8 and (ph, pw) not in self.stats["calibrated"]:
                self._calibrate_bucket(canvas)
                self.stats["calibrated"].append((ph, pw))
            t2 = time.perf_counter()
            seconds["calibrate"] += t2 - t1

            det = {k: v.cpu().numpy() for k, v in self._infer(canvas, ks).items()}
            t3 = time.perf_counter()
            seconds["forward"] += t3 - t2

            batch = {"intrinsics": ks, "image_size": np.asarray([[nh, nw] for (_i, _h, _w, nh, nw, _f) in insts])}
            metas = [{"image_id": "tta", "width": w, "height": h} for (_i, h, w, _nh, _nw, _f) in insts]
            per_ims = unpack_detections(det, batch, metas)  # 2D boxes back to the original resolution
            for per_im, (i, h, w, nh, nw, flipped) in zip(per_ims, insts):
                boxes2d = per_im["boxes2d"]
                quat, tvec = per_im["quat"], per_im["tvec"]
                if flipped:
                    unflipped = boxes2d.copy()
                    unflipped[:, 0] = w - boxes2d[:, 2]
                    unflipped[:, 2] = w - boxes2d[:, 0]
                    boxes2d = unflipped
                    quat, tvec = _flip_boxes3d_np(quat, tvec)
                m = merged[i]
                m["boxes2d"].append(boxes2d)
                m["quat"].append(quat)
                m["tvec"].append(tvec)
                for k in ("classes", "scores", "scores_3d", "size", "conf3d"):
                    m[k].append(per_im[k])
            seconds["merge"] += time.perf_counter() - t3
        t4 = time.perf_counter()
        out = [self._merge_one(m) for m in merged]
        seconds["merge"] += time.perf_counter() - t4
        return out

    def _calibrate_bucket(self, canvas: np.ndarray) -> None:
        """Capture static int8 activation scales on one bucket's first batch
        (one forward) at QUANT_MIN_CH=0 and merge them into the in-memory
        scales, a running max per (path, shape tag)."""
        from dd3d_tpu_torch.models.calibrate import capture_scales

        calib_cfg = self._variant_cfg.clone()
        calib_cfg.TPU.QUANT_MIN_CH = 0  # record every folded conv
        for p, ent in capture_scales(calib_cfg, self.model, [canvas], plain=self.int8_plain).items():
            mine = self._scales.setdefault(p, {})
            for tag, amax in ent.items():
                mine[tag] = max(amax, mine.get(tag, 0.0))

    def _merge_one(self, merged: Dict[str, list]) -> Dict[str, np.ndarray]:
        merged = {k: v for k, v in merged.items() if len(v)}
        out = {k: np.concatenate(v) for k, v in merged.items()}
        if not out:
            out = {k: np.zeros((0,)) for k in ("classes", "scores", "scores_3d")}
        # merged class-aware NMS + top-k (test_time_augmentation.py:163-181)
        if self.nms_thresh > 0 and len(out["classes"]):
            keep = _np_greedy_nms_classaware(out["boxes2d"], out["scores_3d"], out["classes"], self.nms_thresh)
            keep = keep[: self.post_nms_topk]
            out = {k: v[keep] for k, v in out.items()}
        return out

