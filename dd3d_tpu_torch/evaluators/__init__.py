"""Evaluators, dispatched by the evaluator ids of a dataset's metadata; the
port's counterpart of dd3d_tpu/evaluators/__init__.py (cf.
tridet/evaluators/__init__.py:18-38, get_evaluator)."""


def get_evaluator(cfg, dataset_name: str, output_dir=None):
    from dd3d_tpu_torch.data.catalog import MetadataCatalog

    names = MetadataCatalog.get(dataset_name).get("evaluators", ())
    rank0_only = bool(cfg.get("TEST", {}).get("RANK0_METRICS", False))
    evaluators = []
    for name in names:
        if name == "kitti3d_evaluator":
            from dd3d_tpu_torch.evaluators.kitti_3d import KITTI3DEvaluator

            thresholds = cfg.get("EVALUATORS", {}).get("KITTI3D", {}).get("IOU_THRESHOLDS", [0.5, 0.7])
            evaluators.append(KITTI3DEvaluator(dataset_name, iou_thresholds=thresholds, output_dir=output_dir,
                                               rank0_only=rank0_only))
        elif name == "coco_evaluator":
            from dd3d_tpu_torch.evaluators.coco2d import COCO2DEvaluator

            evaluators.append(COCO2DEvaluator(dataset_name, output_dir=output_dir))
        elif name == "nuscenes_evaluator":
            from dd3d_tpu_torch.evaluators.nuscenes import NuscenesEvaluator

            evaluators.append(NuscenesEvaluator(dataset_name, output_dir=output_dir, rank0_only=rank0_only))
        else:
            raise KeyError(f"Unknown evaluator {name!r}")
    return evaluators
