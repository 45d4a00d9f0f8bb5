"""Native nuScenes detection metrics: mAP (center-distance), TP errors, NDS;
the port's copy of dd3d_tpu/evaluators/nuscenes_metrics.py.

Pure-numpy re-implementation of the nuscenes-devkit detection evaluation
(`nuscenes/eval/detection/{algo,evaluate,data_classes}.py`, config
"detection_cvpr_2019"), so the framework computes mAP/NDS standalone — the
reference hard-depends on the devkit (`tridet/evaluators/nuscenes_evaluator.py:73-128`),
which is not installable in every environment.

Semantics follow the devkit exactly:
- per-class greedy matching by 2D center distance at thresholds {0.5, 1, 2, 4} m,
  predictions visited in descending confidence, each GT matched at most once;
- AP = mean over the 101-point interpolated precision curve above
  (recall, precision) = (0.1, 0.1), normalized by (1 - 0.1);
- TP errors (ATE/ASE/AOE/AVE/AAE) are confidence-interpolated cumulative
  means over the matched pairs at dist_th = 2 m, averaged over the achieved
  recall range [0.1, max_recall];
- class/range filtering, per-class exclusions (traffic_cone: no AOE/AVE/AAE;
  barrier: no AVE/AAE), orientation period pi for barriers;
- NDS = (5 * mAP + sum_m max(0, 1 - min(1, err_m))) / 10.

Box format (plain dicts; one list per sample_token):
  GT:   {translation (3,), size (w,l,h), yaw, velocity (2,),
         detection_name, attribute_name, ego_translation (2,)}
  pred: same + detection_score.

Known deviations when GT is assembled from camera dataset dicts (instead of
the devkit DB): GT is restricted to camera-visible annotations, GT velocity
is reconstructed as speed x global heading (direction is not stored), and
the devkit's map-based "bikes in bike racks" removal is skipped. The
devkit's removal of GT boxes with zero lidar+radar points
(loaders.filter_eval_boxes) is applied only when boxes carry a `num_pts`
key — GT assembled from camera dataset dicts has already been
point-count-filtered at dataset build time (nuscenes/build.py:173). See
`gt_from_dataset_dicts`.
"""
import math
from typing import Dict, List, Sequence

import numpy as np

# detection_cvpr_2019 configuration (nuscenes/eval/detection/configs/).
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
MEAN_AP_WEIGHT = 5
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
TP_METRIC_NAMES = {  # devkit display names, mirrored in results dicts
    "trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
    "vel_err": "mAVE", "attr_err": "mAAE",
}
# Per-class TP-metric exclusions (evaluate.py DetectionEval.evaluate).
CLASS_TP_EXCLUSIONS = {
    "traffic_cone": ("attr_err", "vel_err", "orient_err"),
    "barrier": ("attr_err", "vel_err"),
}

_N_REC = 101  # 101-point recall interpolation grid


def center_distance(gt: dict, pred: dict) -> float:
    return float(np.linalg.norm(np.asarray(pred["translation"][:2]) - np.asarray(gt["translation"][:2])))


def scale_iou(gt: dict, pred: dict) -> float:
    """IoU of the two boxes aligned to the same center and rotation
    (devkit utils.scale_iou)."""
    sa = np.clip(np.asarray(gt["size"], dtype=np.float64), 1e-9, None)
    sr = np.clip(np.asarray(pred["size"], dtype=np.float64), 1e-9, None)
    inter = float(np.prod(np.minimum(sa, sr)))
    union = float(np.prod(sa)) + float(np.prod(sr)) - inter
    return inter / union


def angle_diff(x: float, y: float, period: float) -> float:
    """Signed smallest difference of two angles modulo `period`
    (devkit utils.angle_diff)."""
    diff = (x - y + period / 2) % period - period / 2
    if diff > np.pi:
        diff = diff - (2 * np.pi)
    return diff


def yaw_diff(gt: dict, pred: dict, period: float = 2 * np.pi) -> float:
    return abs(angle_diff(float(gt["yaw"]), float(pred["yaw"]), period))


def velocity_l2(gt: dict, pred: dict) -> float:
    gv = np.asarray(gt["velocity"][:2], dtype=np.float64)
    pv = np.asarray(pred["velocity"][:2], dtype=np.float64)
    return float(np.linalg.norm(gv - pv))


def attr_err(gt: dict, pred: dict) -> float:
    if not gt.get("attribute_name"):
        return float("nan")
    return 1.0 - float(gt["attribute_name"] == pred.get("attribute_name", ""))


def quaternion_yaw(wxyz: Sequence[float]) -> float:
    """Yaw of a global-frame box quaternion: the heading of the box x-axis
    projected to the ground plane (devkit utils.quaternion_yaw)."""
    w, x, y, z = [float(v) for v in wxyz]
    # first column of the rotation matrix = R @ [1, 0, 0]
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + z * w)
    return math.atan2(vy, vx)


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit utils.cummean)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sums = np.nancumsum(x.astype(np.float64))
    counts = np.cumsum(~np.isnan(x))
    return np.divide(sums, counts, out=np.zeros_like(sums), where=counts != 0)


class MetricData:
    """Per-(class, dist_th) PR + TP-error curves on the 101-pt recall grid
    (devkit DetectionMetricData)."""

    def __init__(self, recall, precision, confidence, errs: Dict[str, np.ndarray]):
        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.errs = errs

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls):
        grid = np.linspace(0, 1, _N_REC)
        zeros = np.zeros(_N_REC)
        return cls(grid, zeros, zeros, {m: np.ones(_N_REC) for m in TP_METRICS})


def accumulate(
    gt_by_sample: Dict[str, List[dict]],
    pred_by_sample: Dict[str, List[dict]],
    class_name: str,
    dist_th: float,
) -> MetricData:
    """Greedy center-distance matching for one class at one threshold
    (devkit algo.accumulate)."""
    npos = sum(
        1 for boxes in gt_by_sample.values() for g in boxes if g["detection_name"] == class_name
    )
    if npos == 0:
        return MetricData.no_predictions()

    preds = [
        (tok, p)
        for tok, boxes in pred_by_sample.items()
        for p in boxes
        if p["detection_name"] == class_name
    ]
    # devkit tie order (algo.py): sorted ascending by (score, index) then
    # reversed -> descending score, ties broken by DESCENDING insertion index
    preds = [
        preds[i]
        for _, i in sorted(((p["detection_score"], i) for i, (_t, p) in enumerate(preds)), reverse=True)
    ]

    tp, fp, conf = [], [], []
    match = {m: [] for m in TP_METRICS}
    match_conf = []
    taken = set()
    for tok, pred in preds:
        gts = [g for g in gt_by_sample.get(tok, ()) if g["detection_name"] == class_name]
        min_dist, min_idx = np.inf, None
        for gi, g in enumerate(gts):
            if (tok, gi) in taken:
                continue
            d = center_distance(g, pred)
            if d < min_dist:
                min_dist, min_idx = d, gi
        score = float(pred["detection_score"])
        if min_dist < dist_th:
            taken.add((tok, min_idx))
            g = gts[min_idx]
            tp.append(1)
            fp.append(0)
            conf.append(score)
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match["trans_err"].append(center_distance(g, pred))
            match["scale_err"].append(1.0 - scale_iou(g, pred))
            match["orient_err"].append(yaw_diff(g, pred, period))
            match["vel_err"].append(velocity_l2(g, pred))
            match["attr_err"].append(attr_err(g, pred))
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(score)

    if len(match_conf) == 0:
        return MetricData.no_predictions()

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.asarray(conf, dtype=np.float64)
    prec = tp / (tp + fp)
    rec = tp / float(npos)

    grid = np.linspace(0, 1, _N_REC)
    prec_i = np.interp(grid, rec, prec, right=0)
    conf_i = np.interp(grid, rec, conf, right=0)

    errs = {}
    for m in TP_METRICS:
        cm = _cummean(np.asarray(match[m], dtype=np.float64))
        # error as a function of confidence, re-sampled at the grid's
        # confidences (devkit interpolates over DEcreasing confidence).
        errs[m] = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1], cm[::-1])[::-1]
    return MetricData(grid, prec_i, conf_i, errs)


def calc_ap(md: MetricData, min_recall: float = MIN_RECALL, min_precision: float = MIN_PRECISION) -> float:
    prec = md.precision.copy()
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, metric_name: str, min_recall: float = MIN_RECALL) -> float:
    first = round(100 * min_recall) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.errs[metric_name][first:last + 1]))


def filter_boxes(boxes_by_sample: Dict[str, List[dict]], class_range=CLASS_RANGE) -> Dict[str, List[dict]]:
    """Class-specific ego-distance range filter (devkit loaders.filter_eval_boxes)."""
    out = {}
    for tok, boxes in boxes_by_sample.items():
        kept = []
        for b in boxes:
            rng = class_range.get(b["detection_name"])
            if rng is None:
                continue
            if b.get("num_pts", 1) == 0:
                # devkit loaders.filter_eval_boxes removes point-free GT
                continue
            ego = np.asarray(b["ego_translation"][:2], dtype=np.float64)
            d = float(np.linalg.norm(np.asarray(b["translation"][:2]) - ego))
            # strict < matches devkit loaders.filter_eval_boxes
            if d < rng:
                kept.append(b)
        out[tok] = kept
    return out


def compute_detection_metrics(
    gt_by_sample: Dict[str, List[dict]],
    pred_by_sample: Dict[str, List[dict]],
    class_names: Sequence[str],
) -> Dict[str, float]:
    """Full devkit-equivalent metric table: per-class AP by distance
    threshold, TP errors, mAP, NDS."""
    gt_by_sample = filter_boxes(gt_by_sample)
    pred_by_sample = filter_boxes(pred_by_sample)
    for tok, boxes in pred_by_sample.items():
        if len(boxes) > MAX_BOXES_PER_SAMPLE:
            raise ValueError(f"sample {tok}: {len(boxes)} predictions exceed the nuScenes cap")

    md_by = {}
    for cls in class_names:
        for dist_th in DIST_THS:
            md_by[(cls, dist_th)] = accumulate(gt_by_sample, pred_by_sample, cls, dist_th)

    out: Dict[str, float] = {}
    aps = {}
    for cls in class_names:
        for dist_th in DIST_THS:
            aps[(cls, dist_th)] = calc_ap(md_by[(cls, dist_th)])
            out[f"AP_{cls}_{dist_th}"] = aps[(cls, dist_th)]

    mean_dist_aps = {
        dist_th: float(np.mean([aps[(c, dist_th)] for c in class_names])) for dist_th in DIST_THS
    }
    for dist_th, v in mean_dist_aps.items():
        out[f"mAP-{dist_th}"] = v
    mean_ap = float(np.mean(list(aps.values())))

    tp_errors = {}
    for m in TP_METRICS:
        per_class = []
        for cls in class_names:
            if m in CLASS_TP_EXCLUSIONS.get(cls, ()):
                tp_val = float("nan")
            else:
                tp_val = calc_tp(md_by[(cls, DIST_TH_TP)], m)
            out[f"{TP_METRIC_NAMES[m]}_{cls}"] = tp_val
            per_class.append(tp_val)
        tp_errors[m] = float(np.nanmean(per_class)) if not np.all(np.isnan(per_class)) else float("nan")
        out[TP_METRIC_NAMES[m]] = tp_errors[m]

    tp_scores = 0.0
    for m in TP_METRICS:
        v = tp_errors[m]
        score = 0.0 if np.isnan(v) else max(0.0, 1.0 - min(1.0, v))
        # devkit: a NaN mean TP error contributes 0 to NDS only for metrics
        # that are NaN for EVERY class, which cannot happen with the standard
        # 10-class set; guard anyway.
        tp_scores += score

    out["mAP"] = mean_ap
    out["NDS"] = float((MEAN_AP_WEIGHT * mean_ap + tp_scores) / (MEAN_AP_WEIGHT + len(TP_METRICS)))
    return out


# ---------------------------------------------------------------------------
# GT assembly from camera dataset dicts (no devkit).
# ---------------------------------------------------------------------------

def gt_from_dataset_dicts(dicts: Sequence[dict], class_names: Sequence[str],
                          attributes_by_group: Dict[str, List[str]]) -> Dict[str, List[dict]]:
    """Global-frame GT per sample_token from the per-camera dataset dicts.

    Annotations are stored camera-frame (data/datasets/nuscenes.py:117); the
    camera pose transforms them back to the global frame. The same instance
    seen by two cameras is deduplicated by `instance_id`. GT velocity is
    reconstructed as speed x global heading (only the speed norm is stored),
    mirroring how predictions encode velocity
    (tridet/evaluators/nuscenes_evaluator.py:206-208).
    """
    from dd3d_tpu_torch.structures.pose import Pose, _quat_to_matrix_np

    gt: Dict[str, List[dict]] = {}
    seen = set()
    for d in dicts:
        tok = d.get("sample_token", d.get("sample_id"))
        gt.setdefault(tok, [])
        pose_world_cam = d["pose"]
        if isinstance(pose_world_cam, dict):
            pose_world_cam = Pose(wxyz=pose_world_cam["wxyz"], tvec=pose_world_cam["tvec"])
        extr = d.get("extrinsics")
        if isinstance(extr, dict):
            extr = Pose(wxyz=extr["wxyz"], tvec=extr["tvec"])
        ego_t = (pose_world_cam * extr.inverse()).tvec[:2] if extr is not None else pose_world_cam.tvec[:2]
        r_wc = pose_world_cam.rotation_matrix
        for ann in d.get("annotations", ()):
            key = (tok, ann.get("instance_id"))
            if ann.get("instance_id") is not None and key in seen:
                continue
            seen.add(key)
            vec = np.asarray(ann["bbox3d"], dtype=np.float64)
            quat_cam, tvec_cam, wlh = vec[0:4], vec[4:7], vec[7:10]
            t_world = r_wc @ tvec_cam + pose_world_cam.tvec
            r_world = r_wc @ _quat_to_matrix_np(quat_cam / np.linalg.norm(quat_cam))
            yaw = math.atan2(r_world[1, 0], r_world[0, 0])
            speed = float(ann.get("speed", 0.0))
            vel = speed * r_world[:2, 0]
            cls_name = class_names[int(ann["category_id"])]
            group = attributes_by_group.get(cls_name, [])
            attr_id = int(ann.get("attribute_id", len(group)))
            attr_name = group[attr_id] if attr_id < len(group) else ""
            gt[tok].append({
                "translation": t_world.tolist(),
                "size": wlh.tolist(),
                "yaw": yaw,
                "velocity": vel.tolist(),
                "detection_name": cls_name,
                "attribute_name": attr_name,
                "ego_translation": np.asarray(ego_t, dtype=np.float64).tolist(),
            })
    return gt


def preds_from_submission(results: Dict[str, List[dict]], ego_by_sample: Dict[str, Sequence[float]]) -> Dict[str, List[dict]]:
    """Submission-format entries -> metric-engine prediction dicts."""
    out: Dict[str, List[dict]] = {}
    for tok, entries in results.items():
        ego = ego_by_sample.get(tok, (0.0, 0.0))
        out[tok] = [
            {
                "translation": e["translation"],
                "size": e["size"],
                "yaw": quaternion_yaw(e["rotation"]),
                "velocity": e["velocity"],
                "detection_name": e["detection_name"],
                "detection_score": e["detection_score"],
                "attribute_name": e.get("attribute_name", ""),
                "ego_translation": list(ego),
            }
            for e in entries
        ]
    return out
