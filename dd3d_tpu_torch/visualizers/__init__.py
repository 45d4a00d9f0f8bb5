"""Visualizers, dispatched by the visualizer ids of the dataset metadata
(data/datasets/kitti_3d.py sets "loader_visualizers" and
"pred_visualizers"). The port's counterpart of
dd3d_tpu/visualizers/__init__.py (cf. tridet/visualizers/__init__.py:8-17).
They draw with the port's rasterizer (visualizers/raster.py), which equals
cv2 5.0 pixel for pixel, and import no cv2.
"""


def get_dataloader_visualizer(cfg, name: str, dataset_name: str):
    from dd3d_tpu_torch.visualizers.box3d import Box3DDataloaderVisualizer
    from dd3d_tpu_torch.visualizers.d2 import D2DataloaderVisualizer

    if name == "d2_visualizer":
        return D2DataloaderVisualizer(cfg, dataset_name)
    if name == "box3d_visualizer":
        return Box3DDataloaderVisualizer(cfg, dataset_name)
    raise KeyError(name)


def get_predictions_visualizer(cfg, name: str, dataset_name: str, inference_output_dir: str):
    from dd3d_tpu_torch.visualizers.box3d import Box3DPredictionVisualizer
    from dd3d_tpu_torch.visualizers.d2 import D2PredictionVisualizer

    if name == "d2_visualizer":
        return D2PredictionVisualizer(cfg, dataset_name, inference_output_dir)
    if name == "box3d_visualizer":
        return Box3DPredictionVisualizer(cfg, dataset_name, inference_output_dir)
    raise KeyError(name)
