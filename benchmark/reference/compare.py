"""The comparison that decides `correct` for a served detector.

Served detections are judged against the reference's own decode of the
same frames, in two ways.

The dense fields. Each served detection is matched to the location of its
FPN level that explains it best: the location whose reference 2D box and 3D
score of the served class lie nearest, by the larger of the box's largest
coordinate gap over the reference box's longer side and the 3D score's gap.
That larger gap is the detection's gap. Numbers over the sample, each a
mean over the sampled images of one reading an image:
- `det_gap`: the image's worst detection gap, or the gap between its best
  served 3D score and the reference's best kept one where that is larger
  (a served image with no detection where the reference keeps some reads
  that score): an image left out, or its best answer altered, shows here;
- `det_mean`: the mean of the image's detection gaps (an image with no
  detection where the reference keeps some reads its best score);
- `depth_gap`: the image's worst gap between a served depth and the
  reference's depth of its class at the matched location, over 1 m plus
  the reference's (relative where objects are far, absolute near
  MIN_DEPTH's clamp).

The kept set: which candidates the selection and the NMS keep. A served
detection stands for the candidate (level, location, class) it matched. A
decision of the reference is firm where rounding of the stated size cannot
flip it: a candidate kept at NMS_THRESH and at NMS_THRESH -+ the IoU
margin, whose selection margin (reference/decode.py) and lead over the
best candidate that POST_NMS_TOPK cuts off are at least the score margin,
and with no box of its
class that overlaps it past NMS_THRESH - the IoU margin at a score within
the score margin, is firmly kept; a candidate that a firmly kept box of its
class, ahead of it by the score margin, overlaps past NMS_THRESH + the IoU
margin is firmly suppressed. The margins are the configuration's
("compare"). Numbers over the sample:
- `kept_missed`: the share of firmly kept candidates that no served
  detection stands for;
- `suppressed_served`: the share of firmly suppressed candidates that a
  served detection stands for;
each share over at least the configuration's `least_decisions` an image
of the sample, so that a sample with few firm decisions does not read a
few rounding flips as a large share (the limits hold each share less the
same share of the reference in the configuration's own precision:
harness/serve.py);
- `nms_overlap_gap`: the gap between the largest IoU of two served
  detections of one class in one image, over the sample, and the same of
  the reference's kept detections: with many overlapping candidates both
  lie just under NMS_THRESH, whatever the rounding, and an NMS that skips
  suppression or reads another threshold moves the served one;
- `count_gap`: the mean over the images of the gap between the served
  count and the reference's kept count, over the latter.
`summarize` also gives the worst image's `det_gap` and `depth_gap` as
`det_gap_max` and `depth_gap_max`.
"""
from typing import Dict, List

import numpy as np
import torch

from reference import decode

PER_IMAGE = ("det_gap", "det_mean", "depth_gap")
COUNTS = ("n_firm_kept", "n_missed", "n_firm_suppressed", "n_suppressed_served")


def served_images(det: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """A served batch's (B, D, ...) arrays -> per image, its valid detections."""
    out = []
    for i in range(det["valid"].shape[0]):
        sel = np.nonzero(det["valid"][i])[0]
        out.append({
            "box": det["boxes2d"][i][sel].astype(np.float32),
            "score3d": det["scores_3d"][i][sel].astype(np.float32),
            "cls": det["classes"][i][sel].astype(np.int64),
            "level": det["fpn_levels"][i][sel].astype(np.int64),
            "depth": det["boxes3d_depth"][i][sel].reshape(len(sel)).astype(np.float32),
        })
    return out


def match(served: Dict[str, np.ndarray], lv: dict, b: int, sel: np.ndarray, device):
    """(gap, location) of each served detection `sel` of one level."""
    ref_box = lv["box"][b]  # (HW, 4)
    side = torch.maximum(ref_box[:, 2] - ref_box[:, 0], ref_box[:, 3] - ref_box[:, 1]).clamp(min=1.0)
    box = torch.as_tensor(served["box"][sel], device=device)
    box_gap = (ref_box[None] - box[:, None]).abs().amax(dim=-1) / side[None]  # (n, HW)
    cls = torch.as_tensor(served["cls"][sel], device=device)
    ref_s3 = lv["score3d"][b][:, cls].T  # (n, HW)
    score_gap = (ref_s3 - torch.as_tensor(served["score3d"][sel], device=device)[:, None]).abs()
    return torch.maximum(box_gap, score_gap).min(dim=1)


def firm(image: Dict[str, np.ndarray], dec, score_margin: float, iou_margin: float):
    """(firmly kept, firmly suppressed) masks over one image of
    `decode.nms`'s candidates; see the module docstring."""
    t, topk = dec["NMS_THRESH"], dec["POST_NMS_TOPK"]
    iou, valid, cls, s = image["iou"], image["valid"], image["cls"], image["score3d"]
    kept = image["kept"]
    lo = decode.greedy_walk(iou, valid, cls, t - iou_margin, topk)
    hi = decode.greedy_walk(iou, valid, cls, t + iou_margin, topk)
    same = (cls[:, None] == cls[None, :]) & ~np.eye(len(cls), dtype=bool)
    cut = -np.inf  # the best candidate that POST_NMS_TOPK cut off
    if kept.sum() >= topk:
        rest = valid & ~kept & ~(same & (iou > t) & kept[:, None]).any(axis=0)
        rest[:np.nonzero(kept)[0][-1]] = False
        cut = s[rest].max() if rest.any() else -np.inf
    close = (same & (iou > t - iou_margin) & (np.abs(s[:, None] - s[None, :]) < score_margin)).any(axis=1)
    firm_kept = kept & lo & hi & (s >= cut + score_margin) & (image["margin"] >= score_margin) & ~close
    over = same & (iou > t + iou_margin) & (s[:, None] > s[None, :] + score_margin)  # [k, c]: k suppresses c
    firm_suppressed = valid & (over & firm_kept[:, None]).any(axis=0)
    return firm_kept, firm_suppressed


def largest_overlap(served: Dict[str, np.ndarray]) -> float:
    """The largest IoU of two served detections of one class, in float64."""
    box = served["box"].astype(np.float64)
    if len(box) < 2:
        return 0.0
    iou = decode.iou_matrix(torch.as_tensor(box), torch.as_tensor(box)).numpy()
    same = (served["cls"][:, None] == served["cls"][None, :]) & ~np.eye(len(box), dtype=bool)
    return float(iou[same].max()) if same.any() else 0.0


def image_gaps(served: Dict[str, np.ndarray], levels: List[dict], b: int, image: Dict[str, np.ndarray], dec,
               margins: Dict[str, float], device) -> Dict[str, float]:
    """The readings of image `b` of the reference's `levels` (dense fields)
    and `image` (its candidates and NMS, `decode.nms`) against that image's
    `served` detections."""
    gaps = dict.fromkeys(PER_IMAGE, 0.0)
    n = len(served["cls"])
    det, stands = [], set()
    for l in np.unique(served["level"]) if n else []:
        sel = np.nonzero(served["level"] == l)[0]
        lv = levels[int(l)]
        gap, loc = match(served, lv, b, sel, device)
        cls = torch.as_tensor(served["cls"][sel], device=device)
        dep = lv["depth"][b][loc, cls]
        det += gap.tolist()
        stands |= set(zip([int(l)] * len(sel), loc.tolist(), served["cls"][sel].tolist()))
        gaps["depth_gap"] = max(gaps["depth_gap"], float(
            ((dep - torch.as_tensor(served["depth"][sel], device=device)).abs() / (1.0 + dep.abs())).max()))
    kept = image["score3d"][image["kept"]]
    best_served = float(served["score3d"].max()) if n else 0.0
    best = abs(best_served - (float(kept.max()) if len(kept) else 0.0))
    gaps["det_gap"] = max(max(det, default=0.0), best)
    gaps["det_mean"] = float(np.mean(det)) if det else best
    firm_kept, firm_suppressed = firm(image, dec, margins["score_margin"], margins["iou_margin"])
    ident = list(zip(image["level"].tolist(), image["loc"].tolist(), image["cls"].tolist()))
    gaps["n_firm_kept"], gaps["n_firm_suppressed"] = int(firm_kept.sum()), int(firm_suppressed.sum())
    gaps["n_missed"] = sum(ident[j] not in stands for j in np.nonzero(firm_kept)[0])
    gaps["n_suppressed_served"] = sum(ident[j] in stands for j in np.nonzero(firm_suppressed)[0])
    gaps["overlap"] = largest_overlap(served)
    gaps["ref_overlap"] = largest_overlap({"box": image["box"][image["kept"]], "cls": image["cls"][image["kept"]]})
    gaps["count_gap"] = abs(n - len(kept)) / max(len(kept), 1)
    return gaps


def summarize(per_image: List[Dict[str, float]], least_decisions: float = 0.0) -> Dict[str, float]:
    """The sample's numbers from each image's readings; a share is over at
    least `least_decisions` an image."""
    out = {k: float(np.mean([g[k] for g in per_image])) if per_image else 0.0 for k in PER_IMAGE + ("count_gap",)}
    for k in ("det_gap", "depth_gap"):
        out[f"{k}_max"] = max([g[k] for g in per_image] + [0.0])
    total = {k: sum(g[k] for g in per_image) for k in COUNTS}
    out.update(total)
    least = max(least_decisions * len(per_image), 1)
    out["kept_missed"] = total["n_missed"] / max(total["n_firm_kept"], least)
    out["suppressed_served"] = total["n_suppressed_served"] / max(total["n_firm_suppressed"], least)
    out["nms_overlap"] = max([g["overlap"] for g in per_image] + [0.0])
    out["ref_nms_overlap"] = max([g["ref_overlap"] for g in per_image] + [0.0])
    out["nms_overlap_gap"] = abs(out["nms_overlap"] - out["ref_nms_overlap"])
    return out
