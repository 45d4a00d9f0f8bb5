"""The port's CLIs evaluating (`python -m dd3d_tpu_torch.train` with
EVAL_ONLY, the periodic and the final test; `python -m
dd3d_tpu_torch.overfit_smoke`), on the CPU at full width on the port's
KITTI-format fixture at a tiny resize:

- EVAL_ONLY from the checkpoint directory of a one-step CPU train, and
  from a `.pth` state dict of the same weights, gives the results and the
  JSON predictions of that run's final test, in one process; the final
  test of a run on two gloo ranks (each rank's shard, gathered) equals
  EVAL_ONLY of its checkpoint in one process;
- the periodic test at TEST.EVAL_PERIOD=1 leaves the trained state (model
  and optimizer) equal bit for bit to a run without it, and writes its
  results to metrics.jsonl at each step; a failed periodic test is logged
  at world size 1 and raised on every rank at world size 2;
- EVAL_ONLY with TEST.AUG.ENABLED logs the plain results, then the `tta/`
  results, which equal what the JAX package's `_do_test_tta` computes from
  the same detections, and equal on two gloo ranks and in one process;
- a remote MODEL.CKPT raises before anything is built; with the rotated
  BEV NMS, EVAL_ONLY and the final test run, and keep fewer detections;
- the overfit CLI with --iters 2 (and --int8-ab) runs to its OVERFIT
  RESULT and INT8 AB lines, and --skip-train evaluates its checkpoint
  again with the same results.
"""
import json
import os

import numpy as np
import pytest
import torch

from dd3d_tpu_torch import overfit_smoke
from dd3d_tpu_torch import train as train_cli
from dd3d_tpu_torch.overfit_smoke import make_fixture
from tests.torch_dist_workers import cli_rank, failing_eval_cli_rank
from tests.torch_port_util import assert_identical, run_gloo, torch_threads

RESULT_KEY = "kitti_3d/kitti_box3d_r40/Car_Moderate_0.5"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("kitti")), n_images=4)


def small(root, out_root, *extra):
    """dd3d_kitti_dla34_overfit at full width, f32, train and test at short
    side 64, no test-time augmentation, no dataloader drawing."""
    return ["+experiments=dd3d_kitti_dla34_overfit", "--device", "cpu", f"DATASET_ROOT={root}",
            f"OUTPUT_ROOT={out_root}", "INPUT.RESIZE.MIN_SIZE_TRAIN=[64]", "INPUT.RESIZE.MIN_SIZE_TEST=64",
            "SOLVER.IMS_PER_BATCH=2", "TEST.IMS_PER_BATCH=2", "TEST.AUG.ENABLED=False",
            "VIS.DATALOADER_ENABLED=False", "TPU.COMPUTE_DTYPE='float32'", "DATALOADER.TRAIN.USE_PROCESS_POOL=False",
            "DATALOADER.TRAIN.NUM_WORKERS=1", "DATALOADER.TEST.NUM_WORKERS=1", *extra]


def train_args(root, out_root, steps, eval_period=0, *extra):
    return small(root, out_root, f"SOLVER.MAX_ITER={steps}", f"SOLVER.CHECKPOINT_PERIOD={steps}",
                 f"TEST.EVAL_PERIOD={eval_period}", *extra)


def rows_of(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def result_rows(run_dir):
    """metrics.jsonl's lines of test results, without their wall clock."""
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows_of(run_dir) if RESULT_KEY in r]


def predictions(run_dir):
    with open(os.path.join(run_dir, "kitti_predictions.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def one_step_run(fixture_root, tmp_path_factory):
    """A one-step CPU train; its run directory."""
    with torch_threads(4):
        return train_cli.main(train_args(fixture_root, str(tmp_path_factory.mktemp("train")), 1))


def test_training_ends_with_the_final_test(one_step_run):
    rows = rows_of(one_step_run)
    assert [r["step"] for r in rows] == [1, 1] and "total_loss" in rows[0]
    final = result_rows(one_step_run)[0]
    assert all(np.isfinite(v) or k.startswith("bbox/") for k, v in final.items())  # COCO reads NaN without GT
    assert len(predictions(one_step_run)) == 4 * 100  # 100 detections an image at random weights


def test_eval_only_from_a_checkpoint_directory(fixture_root, one_step_run, tmp_path):
    with torch_threads(4):
        run_dir = train_cli.main(small(fixture_root, str(tmp_path), "EVAL_ONLY=True",
                                       f"MODEL.CKPT={os.path.join(one_step_run, 'ckpt')}"))
    assert_identical(result_rows(run_dir), result_rows(one_step_run))  # at the checkpoint's step, 1
    assert predictions(run_dir) == predictions(one_step_run)


def test_eval_only_from_a_pth_state_dict(fixture_root, one_step_run, tmp_path):
    payload = torch.load(os.path.join(one_step_run, "ckpt", "ckpt_00000001.pt"), weights_only=True)
    pth = str(tmp_path / "model_final.pth")
    torch.save(payload["model"], pth)  # the model's (the reference's) parameter names
    with torch_threads(4):
        run_dir = train_cli.main(small(fixture_root, str(tmp_path / "out"), "EVAL_ONLY=True", f"MODEL.CKPT={pth}"))
    (got,), (want,) = result_rows(run_dir), result_rows(one_step_run)
    assert got.pop("step") == 0 and want.pop("step") == 1
    assert_identical(got, want)
    assert predictions(run_dir) == predictions(one_step_run)


def test_periodic_eval_leaves_training_unchanged(fixture_root, tmp_path):
    """Two steps with a test after each against two steps without: the
    checkpoints (parameters, BN statistics, momentum, schedule count) are
    equal bit for bit; the periodic tests are in metrics.jsonl."""
    with torch_threads(4):
        plain = train_cli.main(train_args(fixture_root, str(tmp_path / "plain"), 2))
        evald = train_cli.main(train_args(fixture_root, str(tmp_path / "eval"), 2, 1))
    assert [r["step"] for r in result_rows(evald)] == [1, 2, 2] and [r["step"] for r in result_rows(plain)] == [2]
    assert_identical(result_rows(evald)[-1], result_rows(plain)[-1])
    a, b = (torch.load(os.path.join(d, "ckpt", "ckpt_00000002.pt"), weights_only=True) for d in (plain, evald))
    assert a["step"] == b["step"] == 2 and a["optimizer"]["count"] == b["optimizer"]["count"] == 2

    def assert_same(x, y, what):
        if isinstance(x, dict):
            assert list(x) == list(y), what
            for k in x:
                assert_same(x[k], y[k], f"{what}/{k}")
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y), what
            for i, (u, v) in enumerate(zip(x, y)):
                assert_same(u, v, f"{what}/{i}")
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), what
        else:
            assert x == y, what

    assert_same(a["model"], b["model"], "model")
    assert_same(a["optimizer"], b["optimizer"], "optimizer")


def test_final_test_on_two_gloo_ranks_equals_one_process(fixture_root, tmp_path):
    """Two steps with a periodic test after each on two gloo ranks (the
    model in DDP; each rank tests its half and the evaluators gather), then
    EVAL_ONLY of the run's checkpoint in one process: the final test's
    results and predictions are the same."""
    dirs = run_gloo(cli_rank, 2, train_args(fixture_root, str(tmp_path / "ddp"), 2, 1), out_dir=tmp_path / "ranks",
                    join_group=False, timeout_s=400)
    assert dirs[0] == dirs[1]
    assert [r["step"] for r in result_rows(dirs[0])] == [1, 2, 2]  # rank 0 alone writes
    with torch_threads(4):
        one = train_cli.main(small(fixture_root, str(tmp_path / "one"), "EVAL_ONLY=True",
                                   f"MODEL.CKPT={os.path.join(dirs[0], 'ckpt')}"))
    assert_identical(result_rows(one), result_rows(dirs[0])[-1:])
    assert predictions(one) == predictions(dirs[0])


def test_failed_periodic_eval_is_logged_on_one_rank(fixture_root, tmp_path, monkeypatch, caplog):
    calls = []

    def do_test(cfg, model, output_dir, step=None):
        calls.append(step)
        if len(calls) == 1:
            raise RuntimeError("eval failed")
        return {}

    monkeypatch.setattr(train_cli, "do_test", do_test)
    with torch_threads(4):
        train_cli.main(train_args(fixture_root, str(tmp_path), 1, 1))
    assert calls == [1, 1] and "Periodic eval failed" in caplog.text  # the periodic test, then the final


def test_failed_periodic_eval_raises_on_every_rank(fixture_root, tmp_path):
    got = run_gloo(failing_eval_cli_rank, 2, train_args(fixture_root, str(tmp_path / "out"), 1, 1),
                   out_dir=tmp_path / "ranks", join_group=False, timeout_s=400)
    assert got == ["eval failed at step 1"] * 2


@pytest.mark.parametrize("extra,match", [
    (("EVAL_ONLY=True", "DD3D.INFERENCE.DO_BEV_NMS=True"), "EVAL_ONLY=True would run the rotated BEV NMS"),
    (("SOLVER.MAX_ITER=1", "DD3D.INFERENCE.DO_BEV_NMS=True"), "the final test after training"),
    (("EVAL_ONLY=True", "MODEL.CKPT='s3://bucket/model_final.pth'"), "remote checkpoints"),
    (("EVAL_ONLY=True", "MODEL.CKPT='https://host/model_final.pth'"), "remote checkpoints"),
])
def test_unported_evaluation_options_raise(fixture_root, tmp_path, extra, match):
    """A remote MODEL.CKPT raises. With DD3D.INFERENCE.DO_BEV_NMS,
    EVAL_ONLY and the final test after a one-step train run: the test
    logs finite results, and its predictions are the BEV NMS's survivors,
    fewer than the 100 an image that the plain decode keeps at random
    weights (tests/test_torch_eval_cli.py::test_training_ends_with_the_final_test)."""
    if "remote" in match:
        with pytest.raises(NotImplementedError, match=match):
            train_cli.main(small(fixture_root, str(tmp_path), *extra))
        assert not os.listdir(tmp_path)  # nothing was built or written
        return
    with torch_threads(4):
        run_dir = train_cli.main(small(fixture_root, str(tmp_path), *extra))
    (row,) = result_rows(run_dir)
    assert np.isfinite(row[RESULT_KEY])
    assert 0 < len(predictions(run_dir)) < 4 * 100


def test_eval_only_without_the_checkpoint_raises(fixture_root, tmp_path):
    with pytest.raises(FileNotFoundError):
        train_cli.main(small(fixture_root, str(tmp_path), "EVAL_ONLY=True", f"MODEL.CKPT={tmp_path / 'none.pth'}"))


def test_overfit_cli_runs_to_its_result(fixture_root, tmp_path, capsys):
    args = ["--device", "cpu", "--iters", "2", "--n-images", "4", "--root", str(tmp_path / "fixture"),
            "--output-dir", str(tmp_path / "out"), "INPUT.RESIZE.MIN_SIZE_TRAIN=[64]",
            "INPUT.RESIZE.MIN_SIZE_TEST=64", "SOLVER.IMS_PER_BATCH=2", "TPU.COMPUTE_DTYPE='float32'",
            "DATALOADER.TRAIN.USE_PROCESS_POOL=False", "DATALOADER.TRAIN.NUM_WORKERS=1"]
    with torch_threads(4):
        results = overfit_smoke.main(args + ["--int8-ab"])
        out = capsys.readouterr().out
        again = overfit_smoke.main(args + ["--skip-train"])
    lines = out.splitlines()
    ap = results["kitti_3d"]["kitti_box3d_r40/Car_Moderate_0.5"]
    assert f"OVERFIT RESULT: Car Moderate AP3D@0.5 = {ap:.2f}" in lines
    assert any(line.startswith("OVERFIT RESULT: Car Moderate BEV@0.5 = ") for line in lines)
    assert any(line.startswith("INT8 AB RESULT: worst |dAP| = ") for line in lines)
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert [line for line in lines if line.startswith("KERNEL LAUNCHES")] == [
        f"KERNEL LAUNCHES {arm}: greedy_nms=0 quantize_int8=0 int8_conv=0 conv_dw_s1_same=0"
        for arm in ("train", "bf16", "int8")]
    assert_identical(again, results)
    assert os.path.isfile(tmp_path / "out" / "kitti_predictions.json")


# --- test-time augmentation and the drawings -------------------------------------

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
