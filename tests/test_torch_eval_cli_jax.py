"""The port's CLIs against the JAX package's, on the CPU at full width on
the port's KITTI-format fixture at a tiny resize (the rest of the CLIs'
evaluation: tests/test_torch_eval_cli.py, whose fixtures and helpers this
file shares):

- EVAL_ONLY with TEST.AUG.ENABLED logs the plain results, then the `tta/`
  results, which equal what the JAX package's `_do_test_tta` computes from
  the same detections, and equal on two gloo ranks and in one process;
- the dataloader drawings of a training run, `predict --vis` and the
  `visualize_dataloader` CLI, pixel for pixel the JAX package's (cv2).
"""
import os

import numpy as np

from dd3d_tpu_torch import train as train_cli
from tests.test_torch_eval_cli import (RESULT_KEY, fixture_root, one_step_run, predictions,  # noqa: F401 (fixtures)
                                       result_rows, rows_of, small, train_args)
from tests.torch_dist_workers import cli_rank
from tests.torch_port_util import assert_identical, run_gloo, torch_threads


TTA_ARGS = ("EVAL_ONLY=True", "TEST.AUG.ENABLED=True", "TEST.AUG.MIN_SIZES=[64,96]")


def jax_cfg_of(args):
    """The JAX package's config of the port CLI's arguments, its datasets
    registered."""
    from dd3d_tpu.configs import get_experiment_cfg as jax_experiment_cfg
    from dd3d_tpu.data import register_datasets as jax_register_datasets
    from scripts.train import parse_overrides as jax_parse_overrides

    cfg = jax_parse_overrides([a for a in args if "=" in a and not a.startswith("+")],
                              jax_experiment_cfg("dd3d_kitti_dla34_overfit"))
    jax_register_datasets(cfg)
    return cfg


def test_eval_only_runs_the_plain_then_the_tta_test_as_jax(fixture_root, one_step_run, tmp_path, monkeypatch):
    """EVAL_ONLY with TEST.AUG.ENABLED: metrics.jsonl holds the plain test's
    results (equal to the run's own final test), then the `tta/` results at
    the same step. Fed the port's merged TTA detections, the JAX package's
    `_do_test_tta` (scripts/train.py:216-293) computes the same `tta/`
    results and the same kitti_predictions.json."""
    import scripts.train as jax_train
    from dd3d_tpu.models import tta as jax_tta
    from dd3d_tpu_torch.models import tta as port_tta

    chunks = []
    infer_batch = port_tta.DD3DWithTTA.infer_batch

    def recorded(self, images, intrinsics):
        out = infer_batch(self, images, intrinsics)
        chunks.append(out)
        return out

    monkeypatch.setattr(port_tta.DD3DWithTTA, "infer_batch", recorded)
    args = small(fixture_root, str(tmp_path / "port"), f"MODEL.CKPT={os.path.join(one_step_run, 'ckpt')}", *TTA_ARGS)
    with torch_threads(4):
        run_dir = train_cli.main(args)
    rows = rows_of(run_dir)
    assert [r["step"] for r in rows] == [1, 1] and RESULT_KEY in rows[0] and f"tta/{RESULT_KEY}" in rows[1]
    assert all(k.startswith("tta/") for k in rows[1] if k not in ("step", "ts"))
    assert_identical(result_rows(run_dir), result_rows(one_step_run))
    assert len(chunks) == 2 and [len(c) for c in chunks] == [2, 2]  # TEST.IMS_PER_BATCH=2, one rank

    class Replay:
        """The port's merged detections, chunk after chunk."""

        def __init__(self, cfg, model, variables):
            self.chunks = iter(chunks)

        def infer_batch(self, images, intrinsics):
            assert [im.shape for im in images] == [(375, 1242, 3)] * 2
            return [dict(d) for d in next(self.chunks)]

    monkeypatch.setattr(jax_tta, "DD3DWithTTA", Replay)
    jax_dir = str(tmp_path / "jax")
    jcfg = jax_cfg_of(args)
    want = train_cli.flatten_results(jax_train._do_test_tta(jcfg, None, None, jcfg.DATASETS.TEST.NAME, jax_dir))
    assert_identical({k: v for k, v in rows[1].items() if k not in ("step", "ts")}, want)
    assert predictions(run_dir) == predictions(jax_dir)


def test_tta_on_two_gloo_ranks_equals_one_process(fixture_root, one_step_run, tmp_path):
    """EVAL_ONLY with test-time augmentation on two gloo ranks (each rank's
    InferenceSampler shard in chunks of TEST.IMS_PER_BATCH / 2, gathered by
    the evaluators) and in one process: the same plain and `tta/` results."""
    ckpt = f"MODEL.CKPT={os.path.join(one_step_run, 'ckpt')}"
    dirs = run_gloo(cli_rank, 2, small(fixture_root, str(tmp_path / "ddp"), ckpt, *TTA_ARGS),
                    out_dir=tmp_path / "ranks", join_group=False, timeout_s=400)
    with torch_threads(4):
        one = train_cli.main(small(fixture_root, str(tmp_path / "one"), ckpt, *TTA_ARGS))
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"} for r in rows]  # noqa: E731
    assert dirs[0] == dirs[1] and len(rows_of(one)) == 2
    assert_identical(strip(rows_of(dirs[0])), strip(rows_of(one)))
    assert predictions(dirs[0]) == predictions(one)


def test_training_draws_the_dataloader_as_jax(fixture_root, tmp_path, monkeypatch):
    """Two steps with VIS.DATALOADER_PERIOD=1 and the final test: rank 0
    writes visualization/dataloader_step00000{1,2}_{0,1}.png, pixel for
    pixel what the JAX package's `_visualize_train_batch` draws (with cv2)
    for the same batches, and the final test's prediction drawings
    pred_<image_id>.png (max 8; the fixture has 4 images)."""
    import cv2

    from dd3d_tpu.training.train_loop import _visualize_train_batch as jax_visualize
    from dd3d_tpu_torch.data.imageio import read_image_bgr
    from dd3d_tpu_torch.training import train_loop

    batches = []
    real = train_loop._visualize_train_batch

    def recorded(batch, output_dir, storage, max_n, step):
        batches.append(({k: v.cpu().numpy() for k, v in batch.items()}, step))
        return real(batch, output_dir, storage, max_n, step)

    monkeypatch.setattr(train_loop, "_visualize_train_batch", recorded)
    with torch_threads(4):
        run_dir = train_cli.main(train_args(fixture_root, str(tmp_path / "port"), 2, 0, "VIS.DATALOADER_ENABLED=True",
                                            "VIS.DATALOADER_PERIOD=1"))
    vis = os.path.join(run_dir, "visualization")
    assert sorted(os.listdir(vis)) == [f"dataloader_step00000{s}_{i}.png" for s in (1, 2) for i in (0, 1)] + [
        f"pred_{i:06d}_camera_2.png" for i in range(4)]
    assert [s for _, s in batches] == [1, 2]
    for batch, step in batches:
        jax_visualize(batch, str(tmp_path / "jax"), None, max_n=10, step=step)
        for i in range(2):
            name = f"dataloader_step{step:06d}_{i}.png"
            got = read_image_bgr(os.path.join(vis, name))
            assert got.shape == batch["image"][i].shape
            np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "jax" / "visualization" / name)))


def test_predict_vis_draws_as_jax(fixture_root, tmp_path):
    """`predict --vis` writes each frame with its detections and, with 3D
    boxes, a BEV image: equal to the JAX package's predict --vis drawing
    (scripts/predict.py:184-201, cv2) of the same records."""
    import cv2

    from dd3d_tpu.visualizers.draw import BEVImage, draw_boxes2d, draw_boxes3d
    from dd3d_tpu_torch import predict
    from dd3d_tpu_torch.data.imageio import read_image_bgr

    images = os.path.join(fixture_root, "KITTI3D", "training", "image_2")
    out = tmp_path / "vis"
    with torch_threads(4):
        records = predict.main(["--experiment", "dd3d_kitti_dla34", "--images", images, "--intrinsics",
                                "721.5377,721.5377,609.5593,172.854", "--device", "cpu", "--out",
                                str(tmp_path / "p.json"), "--vis", str(out), "--batch", "2",
                                "INPUT.RESIZE.MIN_SIZE_TEST=64", "TPU.COMPUTE_DTYPE='float32'",
                                "DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK=10"])
    assert len(os.listdir(out)) == 2 * 4
    k = predict.parse_intrinsics("721.5377,721.5377,609.5593,172.854")
    for rec in records:
        img = draw_boxes2d(cv2.imread(rec["file_name"]), np.asarray(rec["boxes2d"], np.float64),
                           classes=np.asarray(rec["classes"]), scores=np.asarray(rec["scores"]),
                           class_names=predict.KITTI_CLASSES)
        img = draw_boxes3d(img, np.asarray(rec["quat"]), np.asarray(rec["tvec"]), np.asarray(rec["size"]), k,
                           classes=np.asarray(rec["classes"]))
        bev = BEVImage().render_boxes3d(np.asarray(rec["quat"]), np.asarray(rec["tvec"]), np.asarray(rec["size"]),
                                        classes=np.asarray(rec["classes"]))
        np.testing.assert_array_equal(read_image_bgr(str(out / f"{rec['image_id']}.png")), img)
        np.testing.assert_array_equal(read_image_bgr(str(out / f"{rec['image_id']}_bev.png")), bev.data)
        assert not np.array_equal(img, cv2.imread(rec["file_name"]))  # boxes were drawn


def test_visualize_dataloader_cli_equals_jax(fixture_root, tmp_path):
    """`python -m dd3d_tpu_torch.visualize_dataloader` and the JAX package's
    scripts/visualize_dataloader.py with the same arguments write the same
    files, pixel for pixel (the seeded train mapper: resize, flip, jitter)."""
    import subprocess
    import sys

    import cv2

    from dd3d_tpu_torch import visualize_dataloader
    from dd3d_tpu_torch.data.imageio import read_image_bgr

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    common = ["--experiment", "dd3d_kitti_dla34_overfit", "--num-images", "3"]
    overrides = [f"DATASET_ROOT={fixture_root}", "INPUT.RESIZE.MIN_SIZE_TRAIN=[96,128]"]
    paths = visualize_dataloader.main([*common, "--output-dir", str(tmp_path / "port"), *overrides])
    proc = subprocess.run([sys.executable, "scripts/visualize_dataloader.py", *common, "--output-dir",
                           str(tmp_path / "jax"), *overrides], cwd=repo, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = sorted(os.path.basename(p) for p in paths)
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"{i:04d}_{v}.png" for i in range(3) for v in ("D2DataloaderVisualizer", "Box3DDataloaderVisualizer"))
    for name in names:
        np.testing.assert_array_equal(read_image_bgr(str(tmp_path / "port" / name)),
                                      cv2.imread(str(tmp_path / "jax" / name)))
