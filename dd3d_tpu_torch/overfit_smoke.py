"""The overfit smoke experiment, the port's counterpart of
scripts/overfit_smoke.py (the reference's `dd3d_kitti_dla34_overfit`
validation recipe, README.md:147-155): write a synthetic KITTI-format
fixture (calib, labels, split, and images with a rendered car at each
ground-truth box; `make_fixture`, equal to scripts/overfit_smoke.py:36-85
and written without cv2, data/imageio.write_png), train
`dd3d_kitti_dla34` on it until the model reproduces it, then run the whole
evaluation stack on it (test loader, forward, decode, NMS kernel, the
KITTI-3D and COCO-2D evaluators, the C++ R40 engine) and print the Car
Moderate AP. With `--int8-ab` the same weights are evaluated again in
static int8, calibrated on the eval loader's batches, and the per-metric
difference is printed.

    python -m dd3d_tpu_torch.overfit_smoke [--iters 400] [--n-images 8] [--int8-ab] [KEY=VALUE ...]
    python -m dd3d_tpu_torch.overfit_smoke --root /tmp/fixture --n-images 8 --fixture-only

`make_nusc_fixture` writes the 6-camera nuScenes-style JSON-manifest fixture
that the nuScenes experiments run from (chip_smoke.py phases 27-28 and the
port's nuScenes CLI tests).

KEY=VALUE overrides apply after the experiment's own. Each kernel's launch
count over the training and over each evaluation is printed (`KERNEL
LAUNCHES`). A rerun with the same `--output-dir` resumes from its latest
checkpoint (`--skip-train` evaluates that checkpoint without training).
"""
import argparse
import json
import logging
import os
import tempfile

import numpy as np

from dd3d_tpu_torch.data.imageio import write_png

CALIB_TEXT = "\n".join(
    [
        "P0: 7.215377e+02 0 6.095593e+02 0 0 7.215377e+02 1.728540e+02 0 0 0 1 0",
        "P1: 7.215377e+02 0 6.095593e+02 -3.875744e+02 0 7.215377e+02 1.728540e+02 0 0 0 1 0",
        "P2: 7.215377e+02 0.0 6.095593e+02 4.485728e+01 0.0 7.215377e+02 1.728540e+02 2.163791e-01 0.0 0.0 1.0 "
        "2.745884e-03",
        "P3: 7.215377e+02 0 6.095593e+02 -3.395242e+02 0 7.215377e+02 1.728540e+02 2.199936e+00 0 0 1 2.729905e-03",
        "R0_rect: 1 0 0 0 1 0 0 0 1",
        "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 7.280733e-04 "
        "-9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01",
        "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0",
    ]
)


def fill_rectangle(img: np.ndarray, pt1, pt2, color) -> None:
    """cv2.rectangle(img, pt1, pt2, color, thickness=-1): every pixel between
    the two corners, both included, clipped to the image."""
    (x1, y1), (x2, y2) = pt1, pt2
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    h, w = img.shape[:2]
    img[max(y1, 0): min(y2, h - 1) + 1, max(x1, 0): min(x2, w - 1) + 1] = color


def make_fixture(root: str, n_images: int = 4):
    """KITTI-format fixture with a rendered box so the 2D branch has visual
    structure to learn from. n_images > 4 varies pose over a grid."""
    os.makedirs(os.path.join(root, "KITTI3D", "mv3d_kitti_splits"), exist_ok=True)
    for sub in ("calib", "label_2", "image_2"):
        os.makedirs(os.path.join(root, "KITTI3D", "training", sub), exist_ok=True)

    rng = np.random.RandomState(0)
    sids = []
    for i in range(n_images):
        sid = f"{i:06d}"
        sids.append(sid)
        # a car at varying x, depth ~14-38m -> decently sized 2D box
        if n_images <= 4:
            x = -2.0 + 1.5 * i
            z = 16.0 + 4.0 * i
        else:
            x = -2.5 + 1.2 * (i % 5)
            z = 14.0 + 3.5 * (i % 8)
        y = 1.65
        h3, w3, l3 = 1.5, 1.6, 3.9
        ry = 0.1 * (i % 12)
        # project center to get a plausible 2D box
        fx, cx_k = 721.5377, 609.5593
        fy, cy_k = 721.5377, 172.854
        u = fx * x / z + cx_k
        v = fy * (y - h3 / 2) / z + cy_k
        bw = fx * l3 / z
        bh = fy * h3 / z
        l2, t2, r2, b2 = u - bw / 2, v - bh / 2, u + bw / 2, v + bh / 2
        label = f"Car 0.00 0 {ry:.2f} {l2:.2f} {t2:.2f} {r2:.2f} {b2:.2f} {h3} {w3} {l3} {x} {y} {z} {ry}\n"

        img = (rng.rand(375, 1242, 3) * 40 + 90).astype(np.uint8)
        fill_rectangle(img, (int(l2), int(t2)), (int(r2), int(b2)), (200, 60, 220))
        fill_rectangle(img, (int(l2) + 4, int(t2) + 4), (int(r2) - 4, int((t2 + b2) / 2)), (40, 200, 60))

        base = os.path.join(root, "KITTI3D", "training")
        with open(os.path.join(base, "calib", f"{sid}.txt"), "w") as f:
            f.write(CALIB_TEXT)
        with open(os.path.join(base, "label_2", f"{sid}.txt"), "w") as f:
            f.write(label)
        write_png(os.path.join(base, "image_2", f"{sid}.png"), img)

    with open(os.path.join(root, "KITTI3D", "mv3d_kitti_splits", "train.txt"), "w") as f:
        f.write("\n".join(sids) + "\n")
    return root


NUSC_FIXTURE = "nusc_fixture"
NUSC_FIXTURE_TVEC = (10.0, -2.0, 1.5)  # sample s's camera -> global translation is this plus (s, 0, 0)


def make_nusc_fixture(root: str, n_samples: int = 8, height: int = 900, width: int = 1600) -> str:
    """A synthetic nuScenes-style fixture, the JSON manifest
    `<root>/json_datasets/nusc_fixture.json` (data/datasets/json_dataset.py)
    that registers as the dataset `nusc_fixture` with the nuScenes
    evaluator: `n_samples` samples of 6 cameras, one PNG each, every camera
    of a sample the same image under the same camera -> global pose (so the
    sample aggregation has 6 copies of each detection to cut, as
    tests/test_nusc_e2e.py's fixture), rotation identity and translation
    NUSC_FIXTURE_TVEC plus (sample, 0, 0). Each image holds one car with a
    3D box, an attribute and a speed, rendered at its projected 2D box."""
    from dd3d_tpu_torch.data.datasets.kitti_3d import _project_corners_bbox2d
    from dd3d_tpu_torch.data.datasets.nuscenes import CLASS_NAMES

    ds_dir = os.path.join(root, "json_datasets")
    os.makedirs(ds_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    s = float(np.sqrt(0.5))
    dicts = []
    for sample in range(n_samples):
        f = 1266.0 * width / 1600
        k = [[f, 0.0, width / 2], [0.0, f, height * 0.55], [0.0, 0.0, 1.0]]
        x, z = -2.0 + 0.5 * (sample % 8), 14.0 + 2.0 * (sample % 6)
        bbox3d = [s, s, 0.0, 0.0, x, 0.3, z, 1.9, 4.6, 1.7]  # quat wxyz (upright), tvec, size wlh
        box = _project_corners_bbox2d(bbox3d, np.asarray(k))
        box = [min(max(v, 0.0), float(lim - 1)) for v, lim in zip(box, (width, height, width, height))]
        img = (rng.rand(height, width, 3) * 40 + 90).astype(np.uint8)
        fill_rectangle(img, (int(box[0]), int(box[1])), (int(box[2]), int(box[3])), (200, 60, 220))
        tx, ty, tz = NUSC_FIXTURE_TVEC
        pose = {"wxyz": [1.0, 0.0, 0.0, 0.0], "tvec": [tx + sample, ty, tz]}
        for cam in range(6):
            name = f"s{sample:03d}_cam{cam}.png"
            write_png(os.path.join(ds_dir, name), img)
            dicts.append({
                "file_name": name, "image_id": f"s{sample:03d}_cam{cam}", "sample_id": f"sample{sample:03d}",
                "sample_token": f"sample{sample:03d}", "width": width, "height": height, "intrinsics": k,
                "pose": pose, "extrinsics": {"wxyz": [1.0, 0.0, 0.0, 0.0], "tvec": [0.0, 0.0, 0.0]},
                "annotations": [{"category_id": 3, "instance_id": f"car{sample}", "bbox": box, "bbox3d": bbox3d,
                                 "attribute_id": 0, "speed": 3.5}],
            })
    manifest = {"name": NUSC_FIXTURE,
                "metadata": {"thing_classes": list(CLASS_NAMES),
                             "id_to_name": {i: n for i, n in enumerate(CLASS_NAMES)},
                             "evaluators": ["nuscenes_evaluator"]},
                "dicts": dicts}
    with open(os.path.join(ds_dir, f"{NUSC_FIXTURE}.json"), "w") as fh:
        json.dump(manifest, fh)
    return root


def overfit_cfg(root: str, iters: int, overrides=()):
    """dd3d_kitti_dla34 trained and tested on the fixture's train split
    (scripts/overfit_smoke.py:116-135), then the KEY=VALUE `overrides`."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.train import parse_overrides

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.DATASET_ROOT = root
    cfg.DATASETS.TRAIN.NAME = "kitti_3d_train"
    cfg.DATASETS.TEST.NAME = "kitti_3d_train"
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.BASE_LR = 0.002
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.STEPS = [iters * 9 // 10]
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 ** 9
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 10.0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.TEST.IMS_PER_BATCH = 4
    # one static shape: train and eval at min side 384
    cfg.INPUT.RESIZE.MIN_SIZE_TRAIN = [384]
    cfg.INPUT.RESIZE.MIN_SIZE_TEST = 384
    cfg.DATALOADER.TRAIN.NUM_WORKERS = 4
    cfg.DATALOADER.TRAIN.SAMPLER = "TrainingSampler"
    return parse_overrides(overrides, cfg)


def kernel_launches() -> dict:
    """The launch counts of the port's kernel wrappers."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same
    from dd3d_tpu_torch.ops.int8_conv import int8_conv
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    return {k.__name__: k.launches for k in (greedy_nms, quantize_int8, int8_conv, conv_dw_s1_same)}


def counted(arm: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), printing the kernels launched inside it."""
    before = kernel_launches()
    out = fn(*args, **kwargs)
    after = kernel_launches()
    print(f"KERNEL LAUNCHES {arm}: " + " ".join(f"{k}={after[k] - before[k]}" for k in after), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=400)
    parser.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "dd3d_overfit_fixture"))
    parser.add_argument("--output-dir", default=os.path.join(tempfile.gettempdir(), "dd3d_overfit_out"))
    parser.add_argument("--min-ap", type=float, default=0.0, help="fail below this Moderate AP")
    parser.add_argument("--n-images", type=int, default=4, help="fixture size; >4 varies car pose over a grid")
    parser.add_argument("--int8-ab", action="store_true",
                        help="after the bf16 eval, evaluate again in static int8 (calibrated on the eval "
                             "loader's batches, QUANT_MIN_CH 32) and print each metric's dAP")
    parser.add_argument("--max-dap", type=float, default=None, help="with --int8-ab: fail if any |dAP| exceeds this")
    parser.add_argument("--quant-unfolded", action="store_true",
                        help="with --int8-ab: also quantize the norm-free predictor convs (TPU.QUANT_UNFOLDED)")
    parser.add_argument("--skip-train", action="store_true",
                        help="evaluate the latest checkpoint in the output directory instead of training")
    parser.add_argument("--fixture-only", action="store_true", help="write the fixture, print its root, and stop")
    parser.add_argument("--device", default="cuda", help="cuda (default), or cpu")
    parser.add_argument("overrides", nargs="*", help="KEY=VALUE config overrides")
    args = parser.parse_intermixed_args(argv)

    make_fixture(args.root, n_images=args.n_images)
    if args.fixture_only:
        print(args.root)
        return None

    import torch

    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.train import do_test, do_train
    from dd3d_tpu_torch.training.checkpoint import CheckpointManager
    from dd3d_tpu_torch.utils.comm import resolve_device

    logging.basicConfig(level=logging.INFO)
    cfg = overfit_cfg(args.root, args.iters, args.overrides)
    device = resolve_device(None if args.device == "cuda" else args.device)
    register_datasets(cfg)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))

    if args.skip_train:
        model = model.to(device)
        step = CheckpointManager(os.path.join(args.output_dir, "ckpt")).restore(model)
        if step is None:
            raise SystemExit(f"--skip-train: no checkpoint in {args.output_dir}/ckpt")
    else:
        state = counted("train", do_train, cfg, model, args.output_dir, device)
        model, step = state.model, state.step
    results = counted("bf16", do_test, cfg, model, args.output_dir, step=step)

    kitti = results.get("kitti_3d", {})
    ap = max((v for k, v in kitti.items() if "Car_Moderate_0.5" in k and "box3d" in k), default=float("nan"))
    bev = max((v for k, v in kitti.items() if "Car_Moderate_0.5" in k and "bev" in k), default=float("nan"))
    print(f"OVERFIT RESULT: Car Moderate AP3D@0.5 = {ap:.2f}")
    print(f"OVERFIT RESULT: Car Moderate BEV@0.5 = {bev:.2f}", flush=True)

    if args.int8_ab:
        # Same weights and evaluation stack; quantization is the only change.
        # Calibration uses the eval loader's own batches, as a deployment
        # calibrates on representative frames.
        loader = build_test_dataloader(cfg, dataset_name=cfg.DATASETS.TEST.NAME)
        calib_images = [batch["image"] for batch, _ in loader]
        ab_cfg = cfg.clone()
        if args.quant_unfolded:
            ab_cfg.TPU.QUANT_UNFOLDED = True
        icfg = prepare_static_scales(ab_cfg, model, calib_images, tag="overfit_ab")
        icfg.TPU.QUANT_MIN_CH = 32  # the shipped gate (bench.py)
        kitti8 = counted("int8", do_test, icfg, model, args.output_dir, step=step).get("kitti_3d", {})
        print("INT8 AB: metric  bf16  int8  dAP")
        worst = 0.0
        for k in sorted(kitti):
            d = kitti8.get(k, float("nan")) - kitti[k]
            worst = max(worst, abs(d))
            print(f"INT8 AB: {k} {kitti[k]:.2f} {kitti8.get(k, float('nan')):.2f} {d:+.2f}")
        print(f"INT8 AB RESULT: worst |dAP| = {worst:.2f}", flush=True)
        if args.max_dap is not None and worst > args.max_dap:
            raise SystemExit(f"int8 |dAP| {worst:.2f} > allowed {args.max_dap}")

    if ap < args.min_ap:
        raise SystemExit(f"AP {ap:.2f} < required {args.min_ap}")
    return results


if __name__ == "__main__":
    main()
