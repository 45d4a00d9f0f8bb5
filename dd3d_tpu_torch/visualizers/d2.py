"""2D (detectron2-style) visualizers: GT and predicted 2D boxes on images.
The port's counterpart of dd3d_tpu/visualizers/d2.py (a rebuild of
`tridet/visualizers/d2_visualizer.py` roles).
"""
import numpy as np

from dd3d_tpu_torch.data.catalog import MetadataCatalog
from dd3d_tpu_torch.visualizers.draw import draw_boxes2d


class D2DataloaderVisualizer:
    def __init__(self, cfg, dataset_name: str):
        self.class_names = MetadataCatalog.get(dataset_name).get("thing_classes", [])

    def visualize(self, sample: dict) -> np.ndarray:
        img = np.ascontiguousarray(sample["image"].astype(np.uint8))
        return draw_boxes2d(img, sample["gt_boxes2d"], sample["gt_classes"], class_names=self.class_names)


class D2PredictionVisualizer:
    def __init__(self, cfg, dataset_name: str, inference_output_dir: str):
        self.class_names = MetadataCatalog.get(dataset_name).get("thing_classes", [])
        self.output_dir = inference_output_dir

    def visualize(self, image: np.ndarray, det: dict, score_thresh: float = 0.3) -> np.ndarray:
        keep = det["scores"] >= score_thresh
        return draw_boxes2d(
            np.ascontiguousarray(image.astype(np.uint8)),
            det["boxes2d"][keep], det["classes"][keep], det["scores"][keep],
            class_names=self.class_names,
        )
