"""KITTI-3D evaluator: R40 AP (3D + BEV) per class x difficulty x IoU
threshold; the port's copy of dd3d_tpu/evaluators/kitti_3d.py.

Rebuild of `tridet/evaluators/kitti_3d_evaluator.py`:
- box convention converter to KITTI (bottom-center, rot_y, alpha)
  (convert_3d_box_to_kitti, :205-264) in pure numpy,
- difficulty filtering with Van<->Car / Person_sitting<->Pedestrian ignore
  rules (clean_kitti_data, :635-746),
- 41-point interpolated PR with MonoDIS-style sampling
  (get_sampled_precision_recall, :389-419),
- sharded IoU matrices + the native C++ matching engine
  (evaluators/native.py, csrc/kitti_eval.cpp), on the host.

Ranks are torch.distributed's (utils/comm.py): each rank processes its own
shard of the test set and `evaluate` gathers every rank's rows.
"""
import json
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from dd3d_tpu_torch.evaluators.native import (
    compute_threshold,
    d3_box_overlap,
    fused_compute_statistics,
    rotated_iou_matrix,
)
from dd3d_tpu_torch.utils import comm

LOG = logging.getLogger(__name__)

DEFAULT_LEVEL_PARAMS = {
    "levels": ("easy", "moderate", "hard"),
    "max_occlusion": (0, 1, 2),
    "max_truncation": (0.15, 0.3, 0.5),
    "min_height": (40, 25, 25),
}


def convert_3d_boxes_to_kitti(quat, tvec, size):
    """Vectorized: (N, 4) quat wxyz + (N, 3) tvec + (N, 3) size (w, l, h) ->
    (N, 8) rows of KITTI (W, L, H, x, y, z, rot_y, alpha).
    cf. kitti_3d_evaluator.py:205-264 (per-box loop there; array-in/array-out
    here — the eval hot path runs per detection at device ingest rates)."""
    quat = np.asarray(quat, dtype=np.float64).reshape(-1, 4)
    tvec = np.asarray(tvec, dtype=np.float64).reshape(-1, 3).copy()
    size = np.asarray(size, dtype=np.float64).reshape(-1, 3)
    n = quat.shape[0]
    if n == 0:
        return np.zeros((0, 8), dtype=np.float64)

    tvec[:, 1] += size[:, 2] / 2.0

    # inverse of the x(+90deg) label rotation: q_inv = [cos(-45deg), sin(-45deg), 0, 0]
    c, s = np.cos(-np.pi / 4), np.sin(-np.pi / 4)
    w1, x1 = c, s
    w2, x2, y2, z2 = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    q = np.stack(
        [
            w1 * w2 - x1 * x2,
            w1 * x2 + x1 * w2,
            w1 * y2 - x1 * z2,
            w1 * z2 + x1 * y2,
        ],
        axis=-1,
    )
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-300)
    vn = np.linalg.norm(q[:, 1:], axis=-1)
    angle = 2.0 * np.arctan2(vn, q[:, 0])
    # wrap to (-pi, pi] like pyquaternion's .angle
    angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
    angle = np.where(angle <= -np.pi, angle + 2 * np.pi, angle)
    axis_z = np.where(vn < 1e-12, 0.0, q[:, 3] / np.maximum(vn, 1e-300))
    rot_y = np.where(axis_z > 0, -angle, angle)

    # alpha from the BEV position of the box (kitti_3d_evaluator.py:246-259)
    theta = np.arctan2(np.abs(tvec[:, 0]), np.abs(tvec[:, 2]))
    alpha = np.where(tvec[:, 0] < 0, rot_y + theta, rot_y - theta)
    alpha = np.where(alpha > np.pi, alpha - 2.0 * np.pi, alpha)
    alpha = np.where(alpha < -np.pi, alpha + 2.0 * np.pi, alpha)
    alpha = np.around(alpha, decimals=2)

    return np.stack(
        [size[:, 0], size[:, 1], size[:, 2], tvec[:, 0], tvec[:, 1], tvec[:, 2], rot_y, alpha], axis=-1
    )


def convert_3d_box_to_kitti(quat, tvec, size):
    """Single-box convenience wrapper over `convert_3d_boxes_to_kitti`."""
    return tuple(convert_3d_boxes_to_kitti(quat, tvec, size)[0])


def clean_kitti_data(gt_anno, dt_anno, current_class, difficulty, id_to_name,
                     level_params=DEFAULT_LEVEL_PARAMS):
    """cf. kitti_3d_evaluator.py:635-746 (semantics preserved exactly)."""
    ignored_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = id_to_name[current_class].lower()
    num_valid_gt = 0

    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]

        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1

        ignore = (
            gt_anno["occluded"][i] > level_params["max_occlusion"][difficulty]
            or gt_anno["truncated"][i] > level_params["max_truncation"][difficulty]
            or height <= level_params["min_height"][difficulty]
        )

        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)

        if gt_name == "dontcare":
            ignored_bboxes.append(bbox)

    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < level_params["min_height"][difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return num_valid_gt, ignored_gt, ignored_dt, ignored_bboxes


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = 41):
    """cf. kitti_3d_evaluator.py:813-847."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.asarray(thresholds)


class KITTIEvaluationEngine:
    """cf. kitti_3d_evaluator.py:267-632."""

    def __init__(self, id_to_name: Dict[int, str], num_shards: int = 50, sample_points: int = 41):
        self.id_to_name = id_to_name
        self.num_shards = num_shards
        self.sample_points = sample_points

    @staticmethod
    def format_annotation(idx, rows, is_prediction):
        """KITTI text rows -> dict of arrays (kitti_3d_evaluator.py:286-325).
        dimensions reordered (H, W, L) -> (L, H, W)."""
        if len(rows) == 0:
            return dict(
                id=f"{idx:06d}", name=np.array([]), truncated=np.array([]),
                occluded=np.array([]), alpha=np.array([]), bbox=np.empty((0, 4)),
                dimensions=np.empty((0, 3)), location=np.empty((0, 3)),
                rotation_y=np.array([]), score=np.array([]),
            )
        data = np.array(rows, dtype=object)
        anno = dict(
            id=f"{idx:06d}",
            name=data[:, 0].astype(str),
            truncated=data[:, 1].astype(np.float64),
            occluded=data[:, 2].astype(np.float64).astype(np.int64),
            alpha=data[:, 3].astype(np.float64),
            bbox=data[:, 4:8].astype(np.float64),
            dimensions=data[:, 8:11].astype(np.float64)[:, [2, 0, 1]],
            location=data[:, 11:14].astype(np.float64),
            rotation_y=data[:, 14].astype(np.float64),
        )
        anno["score"] = data[:, 15].astype(np.float64) if is_prediction else np.zeros(len(rows))
        return anno

    def get_shards(self, num, num_shards):
        num_per_shard = num // num_shards
        remaining = num % num_shards
        full = num_shards * (num_per_shard > 0)
        if remaining == 0:
            return [num_per_shard] * full
        return [num_per_shard] * full + [remaining]

    def _match_matrices(self, gt_annos, dt_annos, metric):
        """Per-shard (dt x gt) overlap matrices. cf. :563-620."""
        total_dt_num = np.array([len(a["name"]) for a in dt_annos])
        total_gt_num = np.array([len(a["name"]) for a in gt_annos])
        shards = self.get_shards(len(gt_annos), self.num_shards)

        overlaps_by_shard = []
        sample_idx = 0
        for num in shards:
            gt_part = gt_annos[sample_idx : sample_idx + num]
            dt_part = dt_annos[sample_idx : sample_idx + num]
            if metric == "BEV_AP":
                def bev5(annos):
                    loc = np.concatenate([a["location"][:, [0, 2]] for a in annos], 0)
                    dims = np.concatenate([a["dimensions"][:, [0, 2]] for a in annos], 0)
                    rots = np.concatenate([a["rotation_y"] for a in annos], 0)
                    return np.concatenate([loc, dims, rots[..., None]], axis=1)

                shard_match = rotated_iou_matrix(bev5(dt_part), bev5(gt_part), criterion=-1)
            elif metric == "BOX3D_AP":
                def box7(annos):
                    loc = np.concatenate([a["location"] for a in annos], 0)
                    dims = np.concatenate([a["dimensions"] for a in annos], 0)
                    rots = np.concatenate([a["rotation_y"] for a in annos], 0)
                    return np.concatenate([loc, dims, rots[..., None]], axis=1)

                shard_match = d3_box_overlap(box7(dt_part), box7(gt_part), criterion=-1)
            else:
                raise ValueError(metric)
            overlaps_by_shard.append(shard_match)
            sample_idx += num

        # flatten to per-image matrices
        overlaps = []
        sample_idx = 0
        for j, num in enumerate(shards):
            gt_idx, dt_idx = 0, 0
            for i in range(num):
                gn = total_gt_num[sample_idx + i]
                dn = total_dt_num[sample_idx + i]
                overlaps.append(overlaps_by_shard[j][dt_idx : dt_idx + dn, gt_idx : gt_idx + gn])
                gt_idx += gn
                dt_idx += dn
            sample_idx += num
        return overlaps, overlaps_by_shard, total_gt_num, total_dt_num

    def _prepare_data(self, gt_annos, dt_annos, class_idx, difficulty_idx):
        # NOTE: DontCare boxes influence only the 2D-bbox metric in the
        # reference (fused statistics take the dontcare list solely for
        # metric==BBOX); the BEV/3D metrics computed here never consume
        # them, so only the ignore flags are materialized.
        gt_list, dt_list = [], []
        ignored_gts, ignored_dets = [], []
        total_num_valid_gt = 0
        for gt_anno, dt_anno in zip(gt_annos, dt_annos):
            num_valid_gt, ignored_gt, ignored_det, _ignored_bboxes = clean_kitti_data(
                gt_anno, dt_anno, class_idx, difficulty_idx, self.id_to_name
            )
            ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
            ignored_dets.append(np.array(ignored_det, dtype=np.int64))
            total_num_valid_gt += num_valid_gt
            gt_list.append(
                np.concatenate(
                    [gt_anno["bbox"], gt_anno["rotation_y"][..., None], gt_anno["alpha"][..., None], gt_anno["dimensions"]],
                    1,
                )
            )
            dt_list.append(
                np.concatenate(
                    [dt_anno["bbox"], dt_anno["rotation_y"][..., None], dt_anno["alpha"][..., None], dt_anno["dimensions"],
                     dt_anno["score"][..., None]],
                    1,
                )
            )
        return gt_list, dt_list, ignored_gts, ignored_dets, total_num_valid_gt

    def eval_metric(self, gt_annos, dt_annos, metric, overlap_thresholds):
        assert len(gt_annos) == len(dt_annos)
        shards = self.get_shards(len(gt_annos), self.num_shards)
        overlaps, overlaps_by_shard, total_gt_num, total_dt_num = self._match_matrices(gt_annos, dt_annos, metric)

        num_classes = len(self.id_to_name)
        num_difficulties = 3
        precision = np.zeros([num_classes, num_difficulties, len(overlap_thresholds), self.sample_points])
        recall = np.zeros_like(precision)

        for class_idx in range(num_classes):
            for difficulty_idx in range(num_difficulties):
                (gt_data_list, dt_data_list, ignored_gts, ignored_dets,
                 total_num_valid_gt) = self._prepare_data(
                    gt_annos, dt_annos, class_idx, difficulty_idx
                )
                for thresh_idx, min_overlap in enumerate(overlap_thresholds):
                    thresholds_list = []
                    for i in range(len(gt_annos)):
                        t = compute_threshold(
                            overlaps[i], dt_data_list[i][:, -1], ignored_gts[i], ignored_dets[i], min_overlap
                        )
                        thresholds_list += t.tolist()
                    if total_num_valid_gt == 0:
                        continue
                    thresholds = get_thresholds(np.array(thresholds_list), total_num_valid_gt, self.sample_points)
                    if len(thresholds) == 0:
                        continue
                    pr = np.zeros([len(thresholds), 8], dtype=np.float64)
                    idx = 0
                    for shard_idx, num in enumerate(shards):
                        fused_compute_statistics(
                            overlaps_by_shard[shard_idx],
                            pr,
                            total_gt_num[idx : idx + num],
                            total_dt_num[idx : idx + num],
                            np.concatenate(gt_data_list[idx : idx + num], 0),
                            np.concatenate(dt_data_list[idx : idx + num], 0),
                            np.concatenate(ignored_gts[idx : idx + num], 0),
                            np.concatenate(ignored_dets[idx : idx + num], 0),
                            min_overlap=min_overlap,
                            thresholds=thresholds,
                        )
                        idx += num
                    for i in range(len(thresholds)):
                        recall[class_idx, difficulty_idx, thresh_idx, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-12)
                        precision[class_idx, difficulty_idx, thresh_idx, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)

        return {"recall": recall, "precision": precision}

    def get_sampled_precision_recall(self, precision, recall):
        recall_spacing = [1.0 / (self.sample_points - 1) * i for i in range(1, self.sample_points)]
        precisions = []
        for r in recall_spacing:
            precisions_above = (recall >= r) * precision
            precisions.append(precisions_above.max(axis=3))
        return precisions, recall_spacing

    def get_mAP(self, precision, recall):
        precisions, recall_spacing = self.get_sampled_precision_recall(precision, recall)
        return sum(precisions) / len(recall_spacing)

    def evaluate(self, gt_annos, dt_annos, overlap_thresholds):
        box3d_pr = self.eval_metric(gt_annos, dt_annos, "BOX3D_AP", overlap_thresholds)
        mAP_3d = self.get_mAP(box3d_pr["precision"], box3d_pr["recall"])
        bev_pr = self.eval_metric(gt_annos, dt_annos, "BEV_AP", overlap_thresholds)
        mAP_bev = self.get_mAP(bev_pr["precision"], bev_pr["recall"])

        results = OrderedDict()
        for class_i, class_name in self.id_to_name.items():
            for diff_i, diff in enumerate(["Easy", "Moderate", "Hard"]):
                for thresh_i, thresh in enumerate(overlap_thresholds):
                    results[f"kitti_box3d_r40/{class_name}_{diff}_{thresh}"] = 100.0 * mAP_3d[class_i, diff_i, thresh_i]
        for class_i, class_name in self.id_to_name.items():
            for diff_i, diff in enumerate(["Easy", "Moderate", "Hard"]):
                for thresh_i, thresh in enumerate(overlap_thresholds):
                    results[f"kitti_bev_r40/{class_name}_{diff}_{thresh}"] = 100.0 * mAP_bev[class_i, diff_i, thresh_i]
        return results


class KITTI3DEvaluator:
    """Accumulates per-image predictions + GT; computes R40 AP.
    cf. kitti_3d_evaluator.py:33-202."""

    def __init__(self, dataset_name: str, iou_thresholds=(0.5, 0.7), output_dir: Optional[str] = None,
                 rank0_only: bool = False):
        self._dataset_dicts = {d["image_id"]: d for d in DatasetCatalog.get(dataset_name)}
        md = MetadataCatalog.get(dataset_name)
        self._class_names = md["thing_classes"]
        self._id_to_name = {i: n for i, n in enumerate(self._class_names)}
        self._iou_thresholds = list(iou_thresholds)
        self._output_dir = output_dir
        # TEST.RANK0_METRICS: compute metrics on process 0 only and broadcast
        # the result dict (the reference's behavior, kitti_3d_evaluator.py:
        # 158-161). Default False = every rank computes identical results —
        # simpler logging, and eval overlaps device inference; at large val
        # sets the N-way duplicated AP engine is real wall clock, so flip
        # this on.
        self._rank0_only = bool(rank0_only)
        self.reset()

    def reset(self):
        self._predictions_kitti = []
        self._groundtruth_kitti = []
        self._predictions_json = []

    def process(self, per_image_detections: List[dict]):
        """per-image dict: image_id, classes (N,), scores (N,), scores_3d (N,),
        boxes2d (N, 4) in ORIGINAL resolution, quat (N, 4), tvec (N, 3),
        size (N, 3)."""
        for det in per_image_detections:
            rows = []
            kitti = convert_3d_boxes_to_kitti(det["quat"], det["tvec"], det["size"])
            boxes2d = np.asarray(det["boxes2d"], dtype=np.float64).reshape(-1, 4)
            for i in range(kitti.shape[0]):
                cls_name = self._class_names[int(det["classes"][i])]
                w, l, h, x, y, z, rot_y, alpha = kitti[i]
                lt, tt, rt, bt = boxes2d[i].tolist()
                rows.append(
                    [cls_name, -1, -1, alpha, lt, tt, rt, bt, h, w, l, x, y, z, rot_y, float(det["scores_3d"][i])]
                )
                self._predictions_json.append(
                    {
                        "image_id": det["image_id"],
                        "category_id": int(det["classes"][i]),
                        "category": cls_name,
                        "bbox": [lt, tt, rt - lt, bt - tt],
                        "score": float(det["scores"][i]),
                        "score_3d": float(det["scores_3d"][i]),
                    }
                )
            self._predictions_kitti.append(rows)

            gt_dict = self._dataset_dicts[det["image_id"]]
            raw = gt_dict.get("raw_kitti_annotations")
            if raw is not None:
                self._groundtruth_kitti.append(raw)
            else:
                gt_rows = []
                annos = gt_dict.get("annotations", [])
                if annos:
                    vecs = np.asarray([a["bbox3d"] for a in annos], dtype=np.float64)
                    kitti_gt = convert_3d_boxes_to_kitti(vecs[:, :4], vecs[:, 4:7], vecs[:, 7:])
                    for anno, row in zip(annos, kitti_gt):
                        cls_name = self._class_names[anno["category_id"]]
                        w, l, h, x, y, z, rot_y, alpha = row
                        lt, tt, rt, bt = anno["bbox"]
                        gt_rows.append([cls_name, -1, -1, alpha, lt, tt, rt, bt, h, w, l, x, y, z, rot_y])
                self._groundtruth_kitti.append(gt_rows)

    def evaluate(self) -> Dict[str, float]:
        """Every rank's predictions and ground truth gathered (the
        reference's comm.gather, kitti_3d_evaluator.py:152-161; the JSON
        predictions ride the same gather), then the R40 engine: on every
        rank, or with TEST.RANK0_METRICS on rank 0 alone, its result
        broadcast so that every rank returns the same dict. Every rank must
        call this: the gather is a collective."""
        preds, gts = self._predictions_kitti, self._groundtruth_kitti
        predictions_json = self._predictions_json
        if comm.is_distributed():
            parts = comm.all_gather_objects((preds, gts, predictions_json))
            preds = [r for p, _, _ in parts for r in p]
            gts = [r for _, g, _ in parts for r in g]
            predictions_json = [r for _, _, j in parts for r in j]
            if self._rank0_only:
                res = self._compute_metrics(preds, gts, predictions_json) if comm.is_main_process() else None
                return comm.broadcast_from_master(res)
        return self._compute_metrics(preds, gts, predictions_json)

    def _compute_metrics(self, preds, gts, predictions_json) -> Dict[str, float]:
        engine = KITTIEvaluationEngine(id_to_name=self._id_to_name)
        gt_annos = [engine.format_annotation(i, rows, False) for i, rows in enumerate(gts)]
        dt_annos = [engine.format_annotation(i, rows, True) for i, rows in enumerate(preds)]
        results = engine.evaluate(gt_annos, dt_annos, self._iou_thresholds)

        if self._output_dir and comm.is_main_process():
            # rank 0 alone writes, as the reference does (kitti_3d_evaluator.py:158-161)
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "kitti_predictions.json"), "w") as f:
                json.dump(predictions_json, f)
        return {"kitti_3d": results}

    def write_submission(self, submission_dir: str):
        """KITTI submission format writer (kitti_3d_evaluator.py:197-202)."""
        os.makedirs(submission_dir, exist_ok=True)
        for idx, rows in enumerate(self._predictions_kitti):
            with open(os.path.join(submission_dir, f"{idx:06d}.txt"), "w") as f:
                for r in rows:
                    f.write(" ".join(str(v) for v in r) + "\n")
