"""Batch-inference (serving) CLI of the port: raw images in, detections out.

    python -m dd3d_tpu_torch.predict --experiment dd3d_kitti_dla34 \
        --ckpt /path/model_final.pth --images /data/frames \
        --intrinsics 721.5,721.5,609.5,172.8 --out preds.json [--device cuda]

With `TPU.QUANT_INT8=True TPU.QUANT_MIN_CH=32 TPU.QUANT_UNFOLDED=True
TPU.QUANT_SCALES_PATH=scales.json` (from `python -m
dd3d_tpu_torch.calibrate_int8`) it serves the static-int8 configuration.

Counterpart of scripts/predict.py: images go through the port's copy of the
JAX package's mapper and collate in inference mode (`dd3d_tpu_torch/data/`:
the port's own PNG reader and PIL-exact resize, ResizeShortestEdge at
INPUT.RESIZE.MIN_SIZE_TEST, intrinsics rescaled, canvas padded to the
backbone's size divisibility), then through the port's model and decode.
It runs on the card; `--device cpu` runs it on the CPU.
`--ckpt` is a reference-named `.pth` state dict; without it the weights are
random, drawn from `--seed`. Detections are written in original image
coordinates. Visualization (`--vis`) is not ported yet.
"""
import argparse
import ast
import glob
import json
import os

import numpy as np
import torch

KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist", "Van", "Truck"]


def parse_intrinsics(spec: str) -> np.ndarray:
    """"fx,fy,cx,cy" or a path to a JSON file holding a 3x3 (or fx/fy/cx/cy)."""
    if os.path.exists(spec):
        with open(spec) as f:
            data = json.load(f)
        if isinstance(data, dict):
            return np.array([[data["fx"], 0, data["cx"]], [0, data["fy"], data["cy"]], [0, 0, 1]], np.float64)
        return np.asarray(data, np.float64).reshape(3, 3)
    fx, fy, cx, cy = (float(v) for v in spec.split(","))
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def list_images(spec: str):
    if os.path.isdir(spec):
        files = sorted(f for ext in ("*.png", "*.jpg", "*.jpeg", "*.PNG", "*.JPG")
                       for f in glob.glob(os.path.join(spec, ext)))
    else:
        files = sorted(glob.glob(spec))
    if not files:
        raise FileNotFoundError(f"no images match {spec!r}")
    return files


def parse_overrides(pairs, cfg):
    """KEY=VALUE config overrides (values parsed as Python literals)."""
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"Override must be KEY=VALUE: {pair!r}")
        key, val = pair.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = val
    return cfg


def read_image_dicts(files, intrinsics):
    """One dataset dict per image file, its size from the PNG header."""
    from dd3d_tpu_torch.data.imageio import png_size

    dicts = []
    for f in files:
        with open(f, "rb") as fh:
            height, width = png_size(fh.read(24))
        dicts.append({"file_name": f, "image_id": os.path.splitext(os.path.basename(f))[0], "intrinsics": intrinsics,
                      "height": height, "width": width})
    return dicts


def iter_batches(cfg, dicts, batch_size: int, size_divisibility: int):
    """(chunk, batch, meta) per `batch_size` dicts, through the mapper in
    inference mode and collate (data/mapper.py): ResizeShortestEdge at
    INPUT.RESIZE.MIN_SIZE_TEST, intrinsics rescaled, canvas padded to
    `size_divisibility`."""
    from dd3d_tpu_torch.data.augmentations import build_augmentation
    from dd3d_tpu_torch.data.mapper import DatasetMapper, collate_batch

    mapper = DatasetMapper(build_augmentation(cfg, is_train=False), is_train=False)
    rng = np.random.RandomState(0)
    for i in range(0, len(dicts), batch_size):
        chunk = dicts[i: i + batch_size]
        batch, meta = collate_batch([mapper(d, rng) for d in chunk], max_gt=1, size_divisibility=size_divisibility)
        yield chunk, batch, meta


def load_model(cfg, ckpt, seed: int, device):
    """The port's model: a reference-named `.pth` state dict or a checkpoint
    directory (training/checkpoint.load_weights), or random weights drawn
    from `seed` when `ckpt` is empty."""
    from dd3d_tpu_torch.models import build_model

    from dd3d_tpu_torch.training.checkpoint import load_weights

    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    if ckpt:
        load_weights(model, ckpt)
    return model.to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--images", required=True, help="directory or glob of input images")
    ap.add_argument("--intrinsics", required=True, help='"fx,fy,cx,cy" or JSON file')
    ap.add_argument("--ckpt", default=None, help="reference-named .pth state dict")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="predictions.json")
    ap.add_argument("--score-thresh", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu")
    ap.add_argument("--seed", type=int, default=0, help="weight seed when no --ckpt is given")
    ap.add_argument("overrides", nargs="*", help="KEY=VALUE config overrides")
    args = ap.parse_args(argv)

    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models.postprocess import get_inference_fn, unpack_detections

    from dd3d_tpu_torch.utils.comm import resolve_device

    device = resolve_device(args.device)
    cfg = get_experiment_cfg(args.experiment)
    parse_overrides(args.overrides, cfg)
    k = parse_intrinsics(args.intrinsics)
    files = list_images(args.images)
    print(f"{len(files)} images, experiment {args.experiment}, device {device}")

    dicts = read_image_dicts(files, k)

    model = load_model(cfg, args.ckpt, args.seed, device)
    infer_fn = get_inference_fn(model, cfg)

    results = []
    for i, (chunk, batch, meta) in enumerate(iter_batches(cfg, dicts, args.batch, model.backbone.size_divisibility)):
        det = infer_fn(batch["image"], batch["intrinsics"])
        rows = unpack_detections(det, batch, meta[: len(chunk)])
        for d, row in zip(chunk, rows):
            keep = np.asarray(row["scores"]) >= args.score_thresh
            rec = {
                "image_id": row["image_id"],
                "file_name": d["file_name"],
                "classes": row["classes"][keep].tolist(),
                "class_names": [KITTI_CLASSES[c % len(KITTI_CLASSES)] for c in row["classes"][keep]],
                "scores": row["scores"][keep].round(4).tolist(),
                "scores_3d": row.get("scores_3d", row["scores"])[keep].round(4).tolist(),
                "boxes2d": row["boxes2d"][keep].round(2).tolist(),
            }
            if "quat" in row:
                rec["quat"] = row["quat"][keep].round(5).tolist()
                rec["tvec"] = row["tvec"][keep].round(3).tolist()
                rec["size"] = row["size"][keep].round(3).tolist()
            results.append(rec)
        print(f"  {min((i + 1) * args.batch, len(dicts))}/{len(dicts)} images done", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {args.out} ({sum(len(r['scores']) for r in results)} detections)")


if __name__ == "__main__":
    main()
