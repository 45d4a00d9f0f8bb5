"""Dataloader visualization CLI of the port, counterpart of
scripts/visualize_dataloader.py (a rebuild of the reference's
`scripts/visualize_dataloader.py`): the first --num-images dataset dicts go
through the train mapper and its augmentations (seeded), and each of the
dataset's loader visualizers (2D boxes; 3D wireframes beside the BEV view)
writes one PNG per sample, `<output-dir>/<index>_<visualizer class>.png`.

    python -m dd3d_tpu_torch.visualize_dataloader --experiment dd3d_kitti_dla34 \\
        --output-dir /tmp/vis DATASET_ROOT=/path/to/kitti [KEY=VALUE ...]

It runs on the host only (numpy drawing, no cv2) and needs no card.
"""
import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", default="dd3d_kitti_dla34")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--num-images", type=int, default=8)
    parser.add_argument("--output-dir", default=os.path.join(tempfile.gettempdir(), "dd3d_tpu_vis"))
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.build import build_train_dataloader
    from dd3d_tpu_torch.data.catalog import MetadataCatalog, register_datasets
    from dd3d_tpu_torch.train import parse_overrides
    from dd3d_tpu_torch.visualizers import get_dataloader_visualizer
    from dd3d_tpu_torch.visualizers.draw import save_vis

    cfg = parse_overrides(args.overrides, get_experiment_cfg(args.experiment))
    register_datasets(cfg)
    dataset_name = args.dataset or cfg.DATASETS.TRAIN.NAME
    md = MetadataCatalog.get(dataset_name)
    visualizers = [get_dataloader_visualizer(cfg, n, dataset_name) for n in md.get("loader_visualizers", ())]

    loader = build_train_dataloader(cfg, dataset_name=dataset_name, batch_size=1, num_workers=1)
    rng = np.random.RandomState(0)
    paths = []
    for count, d in enumerate(loader.dataset_dicts[: args.num_images]):
        sample = loader.mapper(d, rng)  # the mapped sample, before collation
        for vis in visualizers:
            path = save_vis(vis.visualize(sample), args.output_dir, f"{count:04d}_{type(vis).__name__}")
            print("wrote", path)
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
