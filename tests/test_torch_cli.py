"""The port's training CLI (`python -m dd3d_tpu_torch.train`, the counterpart
of scripts/train.py) and the device rule of its entry points:

- `main([...])` with `--device cpu` on two gloo ranks (torchrun's
  environment, as `python -m torch.distributed.run --nproc-per-node 2`
  sets it) trains 2 steps of dd3d_kitti_dla34_overfit at full width on the
  port's fixture at a tiny resize, into one timestamped run directory:
  metrics.jsonl from rank 0 only, finite losses, the checkpoint of step 2,
  and the final test's results;
- W&B, which is not ported, raises before anything is built; with the
  rotated BEV NMS, EVAL_ONLY, the periodic and final tests and the
  dataloader drawing run to their end;
- without a card, the CLI, `train()`, `predict` and `calibrate_int8` raise
  unless the CPU is asked for (`torch.cuda.is_available` is patched to
  False, so the check is the same on a machine with a card).
"""
import json
import os

import numpy as np
import pytest
import torch

from dd3d_tpu_torch import calibrate_int8, predict
from dd3d_tpu_torch import train as train_cli
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.overfit_smoke import make_fixture
from dd3d_tpu_torch.training.checkpoint import CheckpointManager
from dd3d_tpu_torch.training.train_loop import train
from tests.torch_dist_workers import cli_rank
from tests.torch_port_util import run_gloo, torch_threads


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("kitti")), n_images=4)


def cli_args(root, out_root, *extra):
    return ["+experiments=dd3d_kitti_dla34_overfit", "--device", "cpu", f"DATASET_ROOT={root}",
            f"OUTPUT_ROOT={out_root}", "INPUT.RESIZE.MIN_SIZE_TRAIN=[64]", "SOLVER.IMS_PER_BATCH=2",
            "SOLVER.MAX_ITER=2", "SOLVER.CHECKPOINT_PERIOD=2", "TEST.EVAL_PERIOD=0", "VIS.DATALOADER_ENABLED=False",
            "TPU.COMPUTE_DTYPE='float32'", "DATALOADER.TRAIN.USE_PROCESS_POOL=False",
            "DATALOADER.TRAIN.NUM_WORKERS=1", "TEST.AUG.ENABLED=False", "INPUT.RESIZE.MIN_SIZE_TEST=64",
            "TEST.IMS_PER_BATCH=2", "DATALOADER.TEST.NUM_WORKERS=1", *extra]


def test_cli_trains_two_steps_on_two_gloo_ranks(fixture_root, tmp_path):
    out_root = str(tmp_path / "out")
    dirs = run_gloo(cli_rank, 2, cli_args(fixture_root, out_root), out_dir=tmp_path / "ranks", join_group=False,
                    timeout_s=400)
    assert dirs[0] == dirs[1] and dirs[0].startswith(os.path.join(out_root, "dd3d_kitti_dla34_overfit"))
    run_dir = dirs[0]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "total_loss" in r]
    assert [r["step"] for r in train_rows] == [2]  # the last step; rank 0 alone writes
    assert all(np.isfinite(r["total_loss"]) and r["loss_finite"] == 1.0 for r in train_rows)
    test_rows = [r for r in rows if "total_loss" not in r]  # the final test, on both ranks' shards
    assert [r["step"] for r in test_rows] == [2] and "kitti_3d/kitti_box3d_r40/Car_Moderate_0.5" in test_rows[0]
    assert CheckpointManager(os.path.join(run_dir, "ckpt")).steps() == [2]
    payload = torch.load(os.path.join(run_dir, "ckpt", "ckpt_00000002.pt"), weights_only=True)
    assert payload["step"] == 2 and payload["optimizer"]["count"] == 2
    assert not any(k.startswith("module.") for k in payload["model"])  # the model's own names, not DDP's


@pytest.mark.parametrize("override,match", [
    ("EVAL_ONLY=True", "EVAL_ONLY"),
    ("TEST.EVAL_PERIOD=1", "the final test after training"),
    ("VIS.DATALOADER_ENABLED=True", "DO_BEV_NMS"),
    ("WANDB.ENABLED=True", "WANDB"),
])
def test_cli_raises_on_what_is_not_ported(fixture_root, tmp_path, override, match):
    """W&B is not ported and raises before anything is built or written. With
    DD3D.INFERENCE.DO_BEV_NMS, the dataloader drawing and test-time
    augmentation, EVAL_ONLY, a run with the periodic test after every step
    and a run drawing the dataloader now each run to their end: their
    tests, plain and TTA, log finite results."""
    args = cli_args(fixture_root, str(tmp_path), "VIS.DATALOADER_PERIOD=1", "TEST.AUG.ENABLED=True",
                    "DD3D.INFERENCE.DO_BEV_NMS=True", override, "TEST.AUG.MIN_SIZES=[64]")
    if match == "WANDB":
        with pytest.raises(NotImplementedError, match=match):
            train_cli.main(args)
        assert not os.listdir(tmp_path)  # nothing was built or written
        return
    with torch_threads(2):  # test files run in parallel processes
        run_dir = train_cli.main(args)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tests = [r for r in rows if "total_loss" not in r]
    assert len(tests) == {"EVAL_ONLY": 2, "the final test after training": 4, "DO_BEV_NMS": 2}[match]  # + TTA
    key = "kitti_3d/kitti_box3d_r40/Car_Moderate_0.5"
    assert all(np.isfinite(r.get(key, r.get("tta/" + key))) for r in tests)
    assert "tta/" + key in tests[-1]


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(fixture_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in cli_args(fixture_root, str(tmp_path)) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_experiment_cfg("dd3d_kitti_dla34"), [], model=torch.nn.Linear(1, 1), max_iter=1)
    images = os.path.join(fixture_root, "KITTI3D", "training", "image_2")
    common = ["--experiment", "dd3d_kitti_dla34", "--images", images, "--intrinsics", "721.5,721.5,609.5,172.8",
              "--out", str(tmp_path / "out.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(common)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_int8.main(common)
    assert not os.path.exists(tmp_path / "out.json")
