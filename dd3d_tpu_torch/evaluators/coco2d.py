"""COCO-style 2D detection AP evaluator (numpy, dependency-free); the port's
copy of dd3d_tpu/evaluators/coco2d.py.

Replaces the reference's detectron2 `COCOEvaluator` + pycocotools C backend
(tridet/evaluators/__init__.py:23-27): pycocotools is not in this image, so
this is a faithful numpy implementation of the COCO bbox protocol
(pycocotools cocoeval semantics):
- 101-point interpolated AP averaged over IoU in {0.50:0.95:0.05},
- area-range metrics APs/APm/APl (small < 32^2 <= medium < 96^2 <= large)
  with out-of-range GT treated as ignore (not FP for matching detections),
- AR@1 / AR@10 / AR@100 and area-range ARs/ARm/ARl,
- per-class AP, matching d2's COCOEvaluator output table.
"""
import logging
from collections import defaultdict
from typing import Dict, List

import numpy as np

from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from dd3d_tpu_torch.utils import comm

LOG = logging.getLogger(__name__)

IOU_THRESHOLDS = np.round(np.arange(0.5, 0.951, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)

# cocoeval areaRng (pixels^2)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    x1 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    y1 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    x2 = np.minimum(dets[:, None, 2], gts[None, :, 2])
    y2 = np.minimum(dets[:, None, 3], gts[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None] - inter
    return inter / np.maximum(union, 1e-9)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,))
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(boxes[:, 3] - boxes[:, 1], 0, None)


def _match_image(dt_boxes, dt_scores, gt_boxes, area_rng, max_dets):
    """Per-(image, class) greedy matching, cocoeval.evaluateImg semantics.

    Returns (scores, matched (T, D), dt_ignore (T, D), npig) for all IoU
    thresholds at once; D = min(len(dt), max_dets).
    """
    lo, hi = area_rng
    gt_area = _box_area(gt_boxes)
    gt_ig = (gt_area < lo) | (gt_area > hi)
    # gts sorted ignore-last (cocoeval sorts by _ignore)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[g_order]
    gt_ig = gt_ig[g_order]

    d_order = np.argsort(-dt_scores, kind="stable")[:max_dets]
    dt_boxes = dt_boxes[d_order]
    dt_scores = dt_scores[d_order]
    dt_area = _box_area(dt_boxes)

    iou = _iou_matrix(dt_boxes, gt_boxes)
    t_count = len(IOU_THRESHOLDS)
    d_count = len(dt_boxes)
    g_count = len(gt_boxes)
    matched = np.zeros((t_count, d_count), dtype=bool)
    dt_ig = np.zeros((t_count, d_count), dtype=bool)

    for ti, t in enumerate(IOU_THRESHOLDS):
        gt_taken = np.zeros(g_count, dtype=bool)
        for d in range(d_count):
            best = -1
            best_iou = min(t, 1 - 1e-10)
            for g in range(g_count):
                if gt_taken[g]:
                    continue
                # gts are ignore-last: once we have a real match, stop at
                # the first ignored gt (cocoeval: break if m>-1 and gtIg[m]==0
                # and gtIg[gind]==1)
                if best > -1 and not gt_ig[best] and gt_ig[g]:
                    break
                if iou[d, g] < best_iou:
                    continue
                best_iou = iou[d, g]
                best = g
            if best >= 0:
                gt_taken[best] = True
                matched[ti, d] = True
                dt_ig[ti, d] = gt_ig[best]
        # unmatched dets outside the area range are ignored, not FPs
        out_of_rng = (dt_area < lo) | (dt_area > hi)
        dt_ig[ti] |= (~matched[ti]) & out_of_rng

    npig = int((~gt_ig).sum())
    return dt_scores, matched, dt_ig, npig


def _accumulate(per_image, max_dets):
    """per_image: list of (scores, matched, dt_ig, npig) over images of ONE
    class; returns (ap_per_iou (T,), ar_per_iou (T,)) or None if no GT."""
    npig = sum(p[3] for p in per_image)
    if npig == 0:
        return None
    t_count = len(IOU_THRESHOLDS)
    scores = np.concatenate([p[0] for p in per_image]) if per_image else np.zeros((0,))
    order = np.argsort(-scores, kind="mergesort")
    ap = np.zeros(t_count)
    ar = np.zeros(t_count)
    for ti in range(t_count):
        matched = np.concatenate([p[1][ti] for p in per_image])[order]
        ignored = np.concatenate([p[2][ti] for p in per_image])[order]
        keep = ~ignored
        m = matched[keep]
        if len(m) == 0:  # GT present but zero (non-ignored) detections
            ap[ti] = 0.0
            ar[ti] = 0.0
            continue
        tp = np.cumsum(m)
        fp = np.cumsum(~m)
        recall = tp / npig
        precision = tp / np.maximum(tp + fp, 1e-9)
        ar[ti] = recall[-1]
        # monotone envelope
        for i in range(len(precision) - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
        ap[ti] = prec_at.mean()
    return ap, ar


class COCO2DEvaluator:
    """cf. d2 COCOEvaluator as used by the reference
    (tridet/evaluators/__init__.py:23-27); output keys match its bbox table
    (AP, AP50, AP75, APs, APm, APl, per-class AP) plus COCO-summary AR."""

    def __init__(self, dataset_name: str, output_dir=None):
        self._gt = defaultdict(dict)  # class -> img -> boxes
        md = MetadataCatalog.get(dataset_name)
        self._class_names = md["thing_classes"]
        for d in DatasetCatalog.get(dataset_name):
            for a in d.get("annotations", []):
                c = a["category_id"]
                self._gt[c].setdefault(d["image_id"], []).append(a["bbox"])
        self._gt = {
            c: {img: np.asarray(v, dtype=np.float64) for img, v in imgs.items()} for c, imgs in self._gt.items()
        }
        self.reset()

    def reset(self):
        self._dt = defaultdict(lambda: defaultdict(lambda: ([], [])))

    def process(self, per_image_detections: List[dict]):
        for det in per_image_detections:
            for i in range(len(det["classes"])):
                c = int(det["classes"][i])
                boxes, scores = self._dt[c][det["image_id"]]
                boxes.append(det["boxes2d"][i])
                scores.append(float(det["scores"][i]))

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        # Several ranks: merge every rank's per-class/image detections (the
        # reference relies on d2's inference gather); a collective, so every
        # rank calls it.
        if comm.is_distributed():
            merged = defaultdict(lambda: defaultdict(lambda: ([], [])))
            local = {c: {img: (list(b), list(s)) for img, (b, s) in imgs.items()} for c, imgs in self._dt.items()}
            for part in comm.all_gather_objects(local):
                for c, imgs in part.items():
                    for img, (b, s) in imgs.items():
                        eb, es = merged[c][img]
                        eb.extend(b)
                        es.extend(s)
            self._dt = merged

        # per (class, area_rng, max_dets) accumulation
        stats = {}  # (area, md) -> class -> (ap (T,), ar (T,))
        for c, _name in enumerate(self._class_names):
            gt_imgs = self._gt.get(c, {})
            dt_imgs = {
                img: (np.asarray(b, dtype=np.float64).reshape(-1, 4), np.asarray(s, dtype=np.float64))
                for img, (b, s) in self._dt.get(c, {}).items()
            }
            img_ids = gt_imgs.keys() | dt_imgs.keys()
            for area, rng in AREA_RANGES.items():
                # Match ONCE at maxDets=100: dets enter greedy matching in
                # score order, so the maxDets=k result is exactly the
                # k-prefix of the maxDets=100 match (same trick as
                # pycocotools, which matches once and slices).
                per_image = []
                for img in img_ids:
                    gts = gt_imgs.get(img, np.zeros((0, 4)))
                    boxes, scr = dt_imgs.get(img, (np.zeros((0, 4)), np.zeros((0,))))
                    per_image.append(_match_image(boxes, scr, gts, rng, 100))
                acc = _accumulate(per_image, 100)
                if acc is not None:
                    stats.setdefault((area, 100), {})[c] = acc
                if area == "all":
                    for md in MAX_DETS:
                        if md == 100:
                            continue
                        sliced = [(s[:md], m[:, :md], ig[:, :md], npig)
                                  for (s, m, ig, npig) in per_image]
                        acc = _accumulate(sliced, md)
                        if acc is not None:
                            stats.setdefault(("all", md), {})[c] = acc

        def mean_ap(area, md, iou_idx=None):
            per_cls = stats.get((area, md), {})
            if not per_cls:
                return float("nan")
            vals = [v[0].mean() if iou_idx is None else v[0][iou_idx] for v in per_cls.values()]
            return float(np.mean(vals) * 100)

        def mean_ar(area, md):
            per_cls = stats.get((area, md), {})
            if not per_cls:
                return float("nan")
            return float(np.mean([v[1].mean() for v in per_cls.values()]) * 100)

        results = {
            "AP": mean_ap("all", 100),
            "AP50": mean_ap("all", 100, iou_idx=0),
            "AP75": mean_ap("all", 100, iou_idx=5),
            "APs": mean_ap("small", 100),
            "APm": mean_ap("medium", 100),
            "APl": mean_ap("large", 100),
            "AR@1": mean_ar("all", 1),
            "AR@10": mean_ar("all", 10),
            "AR@100": mean_ar("all", 100),
            "ARs": mean_ar("small", 100),
            "ARm": mean_ar("medium", 100),
            "ARl": mean_ar("large", 100),
        }
        for c, name in enumerate(self._class_names):
            acc = stats.get(("all", 100), {}).get(c)
            if acc is not None:
                results[f"AP-{name}"] = float(acc[0].mean() * 100)
        return {"bbox": results}
