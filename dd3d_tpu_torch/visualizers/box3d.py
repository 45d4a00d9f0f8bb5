"""3D box visualizers: projected wireframes beside the BEV view. The port's
counterpart of dd3d_tpu/visualizers/box3d.py (a rebuild of
`tridet/visualizers/box3d_visualizer.py` roles).
"""
import numpy as np

from dd3d_tpu_torch.data.catalog import MetadataCatalog
from dd3d_tpu_torch.visualizers.draw import BEVImage, draw_boxes3d, mosaic


class Box3DDataloaderVisualizer:
    def __init__(self, cfg, dataset_name: str):
        self.class_names = MetadataCatalog.get(dataset_name).get("thing_classes", [])

    def visualize(self, sample: dict) -> np.ndarray:
        """The mapper's 10-vector ground truth (quat, projected center,
        depth, size) decoded through the inverse intrinsics, drawn as
        wireframes and in BEV."""
        img = np.ascontiguousarray(sample["image"].astype(np.uint8))
        g = sample["gt_boxes3d"]
        k = sample["intrinsics"]
        quat, proj_ctr, depth, size = g[:, :4], g[:, 4:6], g[:, 6:7], g[:, 7:]
        inv_k = np.linalg.inv(k)
        rays = np.concatenate([proj_ctr, np.ones_like(depth)], axis=1) @ inv_k.T
        tvec = rays * depth
        wire = draw_boxes3d(img, quat, tvec, size, k, sample["gt_classes"])
        bev = BEVImage().render_boxes3d(quat, tvec, size, sample["gt_classes"]).data
        return mosaic([wire, bev], grid_cols=2)


class Box3DPredictionVisualizer:
    def __init__(self, cfg, dataset_name: str, inference_output_dir: str):
        self.class_names = MetadataCatalog.get(dataset_name).get("thing_classes", [])
        self.output_dir = inference_output_dir

    def visualize(self, image: np.ndarray, det: dict, intrinsics: np.ndarray, score_thresh: float = 0.3) -> np.ndarray:
        keep = det["scores_3d"] >= score_thresh
        img = np.ascontiguousarray(image.astype(np.uint8))
        wire = draw_boxes3d(img, det["quat"][keep], det["tvec"][keep], det["size"][keep], intrinsics,
                            det["classes"][keep])
        bev = BEVImage().render_boxes3d(det["quat"][keep], det["tvec"][keep], det["size"][keep],
                                        det["classes"][keep]).data
        return mosaic([wire, bev], grid_cols=2)
