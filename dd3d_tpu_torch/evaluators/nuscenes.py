"""nuScenes detection evaluator: submission JSON + (optional) devkit NDS;
the port's copy of dd3d_tpu/evaluators/nuscenes.py.

Rebuild of `tridet/evaluators/nuscenes_evaluator.py`:
- per-detection entries with global-frame translation/rotation, (w, l, h)
  size, velocity reconstructed as speed x (global box heading in BEV)
  (nuscenes_evaluator.py:206-208,230-247),
- attribute names from predicted attribute ids per category group,
- submission JSON written to disk; the devkit `DetectionEval` (mAP/NDS) runs
  when nuscenes-devkit is importable, else the native engine
  (nuscenes_metrics.py) scores it against the dataset dicts' annotations.
"""
import json
import logging
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from dd3d_tpu_torch.data.catalog import MetadataCatalog
from dd3d_tpu_torch.data.datasets.nuscenes import CLASS_NAMES
from dd3d_tpu_torch.structures.pose import Pose, _quat_to_matrix_np, _matrix_to_quat_np

LOG = logging.getLogger(__name__)

# attribute-id -> name per category group (inverse of ATTRIBUTE_IDS).
DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked", "bus": "vehicle.parked", "truck": "vehicle.parked",
    "trailer": "vehicle.parked", "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
    "barrier": "", "traffic_cone": "",
}

ATTRIBUTES_BY_GROUP = {
    "car": ["vehicle.moving", "vehicle.parked", "vehicle.stopped"],
    "bus": ["vehicle.moving", "vehicle.parked", "vehicle.stopped"],
    "truck": ["vehicle.moving", "vehicle.parked", "vehicle.stopped"],
    "trailer": ["vehicle.moving", "vehicle.parked", "vehicle.stopped"],
    "construction_vehicle": ["vehicle.moving", "vehicle.parked", "vehicle.stopped"],
    "bicycle": ["cycle.with_rider", "cycle.without_rider"],
    "motorcycle": ["cycle.with_rider", "cycle.without_rider"],
    "pedestrian": ["pedestrian.moving", "pedestrian.standing", "pedestrian.sitting_lying_down"],
    "barrier": [],
    "traffic_cone": [],
}


def build_nusc_detection(det: dict, i: int, pose_world_cam: Pose, class_names) -> dict:
    """One detection -> nuScenes submission entry.
    cf. build_nusc_detection, nuscenes_evaluator.py:230-247."""
    cls_name = class_names[int(det["classes"][i])]
    quat_cam = det["quat"][i] / np.linalg.norm(det["quat"][i])
    r_world = pose_world_cam.rotation_matrix @ _quat_to_matrix_np(quat_cam)
    quat_world = _matrix_to_quat_np(r_world)
    tvec_world = pose_world_cam.rotation_matrix @ det["tvec"][i] + pose_world_cam.tvec

    # velocity = speed * global x-axis of the box, in BEV (z dropped)
    # (nuscenes_evaluator.py:206-208).
    speed = float(det.get("speeds", np.zeros(len(det["classes"])))[i])
    heading = r_world[:, 0]
    vel = speed * heading
    vel[2] = 0.0

    if "attributes" in det and ATTRIBUTES_BY_GROUP[cls_name]:
        attr_id = int(det["attributes"][i])
        group = ATTRIBUTES_BY_GROUP[cls_name]
        # out-of-range ids (incl. the shared "ignore" id 3) wrap modulo the
        # group, matching the reference exactly (nuscenes_evaluator.py:196-201)
        attr_name = group[attr_id % len(group)]
    else:
        attr_name = DEFAULT_ATTRIBUTES[cls_name]

    w, l, h = det["size"][i].tolist()
    return {
        "sample_token": det["sample_id"],
        "translation": tvec_world.tolist(),
        "size": [w, l, h],
        "rotation": quat_world.tolist(),
        "velocity": vel[:2].tolist(),
        "detection_name": cls_name,
        "detection_score": float(det["scores_3d"][i]),
        "attribute_name": attr_name,
    }


class NuscenesEvaluator:
    """cf. NuscenesEvaluator, nuscenes_evaluator.py:131-312."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None, rank0_only: bool = False):
        self._dataset_name = dataset_name
        md = MetadataCatalog.get(dataset_name)
        self._class_names = md.get("thing_classes", list(CLASS_NAMES))
        self._output_dir = output_dir or os.path.join(tempfile.gettempdir(), "dd3d_tpu_nusc_eval")
        # TEST.RANK0_METRICS: run the metric engine (and the submission
        # write) on process 0 only, broadcast the result dict. See
        # KITTI3DEvaluator for the rationale.
        self._rank0_only = bool(rank0_only)
        self.reset()

    def reset(self):
        self._results = defaultdict(list)

    def process(self, per_image_detections: List[dict], poses: Optional[List[Pose]] = None):
        # Samples with zero detections still need a results entry, or their
        # GT would be dropped by the predicted-samples restriction and their
        # objects never counted as misses ("This handles samples with no
        # detections", nuscenes_evaluator.py:164-166).
        for det in per_image_detections:
            self._results[det["sample_id"]]  # defaultdict touch
        for j, det in enumerate(per_image_detections):
            pose = poses[j] if poses is not None else det.get("pose") or Pose()
            if isinstance(pose, dict):
                pose = Pose(wxyz=pose["wxyz"], tvec=pose["tvec"])
            for i in range(len(det["classes"])):
                entry = build_nusc_detection(det, i, pose, self._class_names)
                self._results[entry["sample_token"]].append(entry)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        # Multi-host: merge per-sample results from all processes
        # (gather_dict, nuscenes_evaluator.py:255-260).
        from dd3d_tpu_torch.utils.comm import gather_dict, is_distributed

        if is_distributed():
            self._results = defaultdict(list, gather_dict(dict(self._results)))
            if self._rank0_only:
                from dd3d_tpu_torch.utils.comm import broadcast_from_master, is_main_process

                res = self._evaluate_merged() if is_main_process() else None
                return broadcast_from_master(res)
        return self._evaluate_merged()

    def _evaluate_merged(self) -> Dict[str, Dict[str, float]]:
        os.makedirs(self._output_dir, exist_ok=True)

        def top500(entries):
            # nuScenes caps 500 dets/sample; keep the BEST by score — a
            # positional v[:500] would drop whole cameras in insertion order
            # when aggregation is off (6 x POST_NMS_TOPK can exceed 500).
            if len(entries) <= 500:
                return entries
            return sorted(entries, key=lambda e: -e["detection_score"])[:500]

        self._capped_results = {k: top500(v) for k, v in self._results.items()}
        submission = {
            "meta": {
                "use_camera": True, "use_lidar": False, "use_radar": False,
                "use_map": False, "use_external": False,
            },
            "results": self._capped_results,
        }
        path = os.path.join(self._output_dir, "nusc_submission.json")
        with open(path, "w") as f:
            json.dump(submission, f)
        LOG.info("Wrote nuScenes submission: %s (%d samples)", path, len(self._results))

        try:
            return {"nuscenes": self._run_devkit_eval(path)}
        except ImportError:
            LOG.info("nuscenes-devkit not available; using the native metric engine.")
        except Exception:
            # e.g. stock DetectionEval's pred-tokens == gt-tokens assert on a
            # partial eval set (the reference patches exactly this,
            # nuscenes_evaluator.py:73-128) — fall back to the native engine
            # rather than losing the whole evaluation.
            LOG.warning("devkit evaluation failed; falling back to the native engine.", exc_info=True)
        try:
            return {"nuscenes": self._run_native_eval()}
        except Exception:
            LOG.warning(
                "Native nuScenes eval failed (dataset dicts unavailable?); "
                "submission written, NDS not computed.", exc_info=True,
            )
            return {"nuscenes": {"submission": 1.0}}

    def _run_native_eval(self) -> Dict[str, float]:
        """Devkit-free mAP/NDS via the pure-numpy metric engine
        (`nuscenes_metrics.py`), with GT assembled from the registered
        dataset dicts. See that module's docstring for the (documented)
        deviations vs the devkit GT database."""
        from dd3d_tpu_torch.data.catalog import DatasetCatalog
        from dd3d_tpu_torch.evaluators.nuscenes_metrics import (
            compute_detection_metrics,
            gt_from_dataset_dicts,
            preds_from_submission,
        )

        dicts = DatasetCatalog.get(self._dataset_name)
        gt = gt_from_dataset_dicts(dicts, self._class_names, ATTRIBUTES_BY_GROUP)
        ego_by_sample = {}
        for g_tok, boxes in gt.items():
            if boxes:
                ego_by_sample[g_tok] = boxes[0]["ego_translation"]
        # samples with no GT still need an ego for the pred range filter
        for d in dicts:
            tok = d.get("sample_token", d.get("sample_id"))
            if tok not in ego_by_sample:
                pose = d["pose"]
                if isinstance(pose, dict):
                    pose = Pose(wxyz=pose["wxyz"], tvec=pose["tvec"])
                extr = d.get("extrinsics")
                if isinstance(extr, dict):
                    extr = Pose(wxyz=extr["wxyz"], tvec=extr["tvec"])
                ego = (pose * extr.inverse()).tvec if extr is not None else pose.tvec
                ego_by_sample[tok] = ego[:2].tolist()
        # reuse the already-capped submission entries (same top-500 policy)
        preds = preds_from_submission(self._capped_results, ego_by_sample)
        # restrict GT to predicted samples, like the reference's patched
        # DetectionEval (tridet/evaluators/nuscenes_evaluator.py:73-128)
        gt = {tok: gt.get(tok, []) for tok in preds}
        metrics = compute_detection_metrics(gt, preds, self._class_names)
        return {k: float(v) for k, v in metrics.items()}

    def _run_devkit_eval(self, submission_path: str) -> Dict[str, float]:
        from nuscenes.nuscenes import NuScenes  # type: ignore
        from nuscenes.eval.detection.config import config_factory  # type: ignore
        from nuscenes.eval.detection.evaluate import DetectionEval  # type: ignore

        from dd3d_tpu_torch.data.datasets.nuscenes import DATASET_NAME_TO_VERSION

        md = MetadataCatalog.get(self._dataset_name)
        version, split = DATASET_NAME_TO_VERSION[self._dataset_name]
        nusc = NuScenes(version=version, dataroot=md["root_dir"], verbose=False)
        cfg = config_factory("detection_cvpr_2019")
        nusc_eval = DetectionEval(
            nusc, config=cfg, result_path=submission_path,
            eval_set=split, output_dir=self._output_dir, verbose=False,
        )
        metrics = nusc_eval.main(render_curves=False)
        out = {"mAP": float(metrics["mean_ap"]), "NDS": float(metrics["nd_score"])}
        for k, v in metrics.get("mean_dist_aps", {}).items():
            out[f"mAP-{k}"] = float(v)
        return out
