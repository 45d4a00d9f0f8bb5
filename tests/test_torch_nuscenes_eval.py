"""nuScenes evaluation in the port against the JAX package, on the CPU:

- `evaluators/nuscenes_metrics.py`: the metrics dict of
  `compute_detection_metrics` equal key for key and value for value to
  JAX's on seeded global-frame GT and predictions (matches, misses, false
  positives, the range filter, point-free GT); `gt_from_dataset_dicts` and
  `preds_from_submission` equal to JAX's;
- `NuscenesEvaluator`: for the same per-image detections, the same results
  dict and nusc_submission.json as JAX's, in one process, and on two gloo
  ranks (each rank's whole samples, gathered) the same as in one process,
  under TEST.RANK0_METRICS too; the devkit path raises ImportError, so the
  native engine scores, as in JAX;
- the registrations: the JSON-manifest dataset and the nuScenes datasets
  (names, metadata, dataset dicts) equal to JAX's; the devkit builder
  raises JAX's ImportError without `nuscenes`;
- the CLI (`python -m dd3d_tpu_torch.train +experiments=dd3d_nusc_dla34
  EVAL_ONLY=True --device cpu`) on a tiny 6-camera fixture: the plain test
  (sample aggregation on the serving path) and the TTA test
  (NuscenesDD3DWithTTA, the host aggregation), whose results equal what
  the JAX package's `do_test` and `_do_test_tta` compute from the same
  detections (the TTA merge's samples aggregated by JAX's own
  `nuscenes_sample_aggregate`), and the same TTA submission.
"""
import json
import os
import types

import numpy as np
import pytest

import dd3d_tpu.evaluators.nuscenes_metrics as jm
import dd3d_tpu_torch.evaluators.nuscenes_metrics as pm
from dd3d_tpu.configs import get_experiment_cfg as jax_get_experiment_cfg
from dd3d_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog, MetadataCatalog as JaxMetadataCatalog
from dd3d_tpu.data.catalog import register_datasets as jax_register_datasets
from dd3d_tpu.evaluators.nuscenes import ATTRIBUTES_BY_GROUP as JAX_ATTRIBUTES_BY_GROUP
from dd3d_tpu.evaluators.nuscenes import NuscenesEvaluator as JaxNuscenesEvaluator
from dd3d_tpu_torch import train as train_cli
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog, register_datasets
from dd3d_tpu_torch.data.datasets import nuscenes as pnusc
from dd3d_tpu_torch.evaluators import get_evaluator
from dd3d_tpu_torch.evaluators.nuscenes import ATTRIBUTES_BY_GROUP, NuscenesEvaluator
from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture
from tests.torch_dist_workers import nusc_eval_rank, seeded_nusc_detections
from tests.torch_port_util import assert_identical, run_gloo, torch_threads

CLASSES = list(pnusc.CLASS_NAMES)


def seeded_boxes(seed: int, n_samples: int = 6):
    """Global-frame GT and predictions a sample in the metric engine's
    schema: each GT matched at a jittered centre or missed, false positives,
    GT without points, boxes past the class range."""
    rng = np.random.RandomState(seed)
    gt, preds = {}, {}
    for s in range(n_samples):
        tok, ego = f"s{s}", rng.uniform(-5, 5, 2).tolist()
        g_boxes, p_boxes = [], []
        for _ in range(rng.randint(2, 8)):
            cls = CLASSES[rng.randint(0, 10)]
            group = ATTRIBUTES_BY_GROUP[cls]
            box = {"translation": (rng.uniform(-40, 40, 3) + [*ego, 0]).tolist(),
                   "size": rng.uniform(0.5, 5, 3).tolist(), "yaw": float(rng.uniform(-np.pi, np.pi)), "velocity": rng.uniform(-5, 5, 2).tolist(),
                   "detection_name": cls, "attribute_name": group[rng.randint(len(group))] if group else "",
                   "ego_translation": ego, "num_pts": int(rng.rand() > 0.1)}
            g_boxes.append(box)
            if rng.rand() < 0.8:
                p = dict(box, detection_score=float(rng.rand()))
                p["translation"] = (np.asarray(box["translation"]) + rng.normal(0, 0.8, 3)).tolist()
                p["size"] = (np.asarray(box["size"]) * rng.uniform(0.8, 1.2, 3)).tolist()
                p["yaw"] = box["yaw"] + float(rng.normal(0, 0.3))
                p.pop("num_pts")
                p_boxes.append(p)
        for _ in range(rng.randint(0, 4)):  # false positives
            p_boxes.append({"translation": (rng.uniform(-50, 50, 3)).tolist(), "size": rng.uniform(0.5, 5, 3).tolist(),
                            "yaw": 0.0, "velocity": [0.0, 0.0], "detection_name": CLASSES[rng.randint(0, 10)],
                            "attribute_name": "", "ego_translation": ego, "detection_score": float(rng.rand())})
        gt[tok], preds[tok] = g_boxes, p_boxes
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_engine_matches_jax(seed):
    gt, preds = seeded_boxes(seed)
    got = pm.compute_detection_metrics(gt, preds, CLASSES)
    want = jm.compute_detection_metrics(gt, preds, CLASSES)
    assert list(got) == list(want) and 0 < got["mAP"] < 1 and 0 < got["NDS"] < 1
    assert_identical(got, want)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    """A tiny 6-camera fixture (4 samples of 6 cameras at 90x160),
    registered in both packages' catalogs."""
    root = make_nusc_fixture(str(tmp_path_factory.mktemp("nusc")), n_samples=4, height=90, width=160)
    for register, get in ((register_datasets, get_experiment_cfg), (jax_register_datasets, jax_get_experiment_cfg)):
        cfg = get("dd3d_nusc_dla34")
        cfg.DATASET_ROOT = root
        register(cfg)
    return root


def test_gt_and_submission_conversions_match_jax(nusc_root):
    dicts = DatasetCatalog.get(NUSC_FIXTURE)
    gt = pm.gt_from_dataset_dicts(dicts, CLASSES, ATTRIBUTES_BY_GROUP)
    assert gt == jm.gt_from_dataset_dicts(JaxDatasetCatalog.get(NUSC_FIXTURE), CLASSES, JAX_ATTRIBUTES_BY_GROUP)
    assert sum(len(v) for v in gt.values()) == 4  # one car a sample, seen by its 6 cameras
    sub = {"s0": [{"translation": [1.0, 2.0, 3.0], "size": [1, 2, 3], "rotation": [0.9, 0.1, 0.3, 0.3],
                   "velocity": [0.5, 0.1], "detection_name": "car", "detection_score": 0.7,
                   "attribute_name": "vehicle.moving"}]}
    ego = {"s0": [0.5, 0.5]}
    assert pm.preds_from_submission(sub, ego) == jm.preds_from_submission(sub, ego)


def test_registrations_match_jax(nusc_root):
    assert pnusc.DATASET_NAME_TO_VERSION == jax_nusc_module().DATASET_NAME_TO_VERSION
    for name in [NUSC_FIXTURE, *pnusc.DATASET_NAME_TO_VERSION]:
        md, jmd = MetadataCatalog.get(name), JaxMetadataCatalog.get(name)
        assert {k: md[k] for k in md if k != "root_dir"} == {k: jmd[k] for k in jmd if k != "root_dir"}, name
    assert DatasetCatalog.get(NUSC_FIXTURE) == JaxDatasetCatalog.get(NUSC_FIXTURE)
    with pytest.raises(ImportError, match="nuscenes-devkit is required"):
        DatasetCatalog.get("nusc_mini_val")
    with pytest.raises(ImportError, match="nuscenes-devkit is required"):
        JaxDatasetCatalog.get("nusc_mini_val")
    jnusc = jax_nusc_module()
    assert pnusc.CAMERA_NAMES == jnusc.CAMERA_NAMES and pnusc.ATTRIBUTE_IDS == jnusc.ATTRIBUTE_IDS
    assert pnusc.CATEGORY_REMAP == jnusc.CATEGORY_REMAP and pnusc.CLASS_NAMES == tuple(CLASSES)
    assert pnusc.MAX_NUM_ATTRIBUTES == jnusc.MAX_NUM_ATTRIBUTES


def jax_nusc_module():
    import dd3d_tpu.data.datasets.nuscenes as jnusc

    return jnusc


def test_project_bbox2d_matches_jax():
    rng = np.random.RandomState(0)
    k = np.asarray([[1266.0, 0, 816.0], [0, 1266.0, 491.0], [0, 0, 1]])
    for _ in range(20):
        q = rng.normal(size=4)
        box = [*(q / np.linalg.norm(q)), *rng.uniform([-20, -2, 2], [20, 2, 60]), *rng.uniform(0.5, 5, 3)]
        assert pnusc._project_bbox2d(box, k, 1600, 900) == jax_nusc_module()._project_bbox2d(box, k, 1600, 900)


def evaluate_both(dets, tmp_path, rank0_only=False):
    out = {}
    for name, cls in (("port", NuscenesEvaluator), ("jax", JaxNuscenesEvaluator)):
        ev = cls(NUSC_FIXTURE, output_dir=str(tmp_path / name), rank0_only=rank0_only)
        ev.reset()
        ev.process([dict(d) for d in dets])
        out[name] = (ev.evaluate(), json.loads((tmp_path / name / "nusc_submission.json").read_text()))
    return out


def test_evaluator_matches_jax(nusc_root, tmp_path):
    dets = seeded_nusc_detections(DatasetCatalog.get(NUSC_FIXTURE))
    out = evaluate_both(dets, tmp_path)
    (res, sub), (jres, jsub) = out["port"], out["jax"]
    assert list(res) == ["nuscenes"] and 0 < res["nuscenes"]["mAP"] and np.isfinite(res["nuscenes"]["NDS"])
    assert_identical(res, jres)
    assert sub == jsub and len(sub["results"]) == 4


def test_get_evaluator_builds_the_nuscenes_evaluator(nusc_root):
    cfg = get_experiment_cfg("dd3d_nusc_dla34")
    cfg.TEST.RANK0_METRICS = True
    (ev,) = get_evaluator(cfg, NUSC_FIXTURE, output_dir="out")
    assert isinstance(ev, NuscenesEvaluator) and ev._rank0_only and ev._output_dir == "out"


@pytest.mark.parametrize("rank0_only", [False, True])
def test_evaluator_on_two_gloo_ranks_equals_one_process(nusc_root, tmp_path, rank0_only):
    ranks = run_gloo(nusc_eval_rank, 2, nusc_root, rank0_only, str(tmp_path), out_dir=tmp_path / "ranks")
    dets = seeded_nusc_detections(DatasetCatalog.get(NUSC_FIXTURE))
    want, want_sub = evaluate_both(dets, tmp_path / "one")["port"]
    assert [r["n_local"] for r in ranks] == [12, 12]  # whole samples of 6 cameras a rank
    for rank, r in enumerate(ranks):
        assert_identical(r["results"], want, f"rank {rank}")
    assert ranks[0]["written"] == want_sub
    assert (ranks[1]["written"] is None) == rank0_only


# --- the CLI --------------------------------------------------------------------

def cli_args(root, out_root, *extra):
    """dd3d_nusc_dla34 at full width and f32 on the tiny fixture, the test at
    short side 64, TTA at [64, 96] with flip, every candidate kept."""
    return ["+experiments=dd3d_nusc_dla34", "--device", "cpu", f"DATASET_ROOT={root}",
            f"DATASETS.TEST.NAME={NUSC_FIXTURE}", f"OUTPUT_ROOT={out_root}", "EVAL_ONLY=True",
            "INPUT.RESIZE.MIN_SIZE_TEST=64", "TEST.AUG.MIN_SIZES=[64,96]", "TEST.IMS_PER_BATCH=12",
            "TPU.COMPUTE_DTYPE='float32'", "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0",
            "DATALOADER.TEST.NUM_WORKERS=1", *extra]


def jax_cfg(root, out_root):
    cfg = jax_get_experiment_cfg("dd3d_nusc_dla34")
    cfg.DATASET_ROOT, cfg.DATASETS.TEST.NAME, cfg.OUTPUT_ROOT = root, NUSC_FIXTURE, out_root
    cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.TEST.AUG.MIN_SIZES, cfg.TEST.IMS_PER_BATCH = 64, [64, 96], 12
    cfg.TPU.COMPUTE_DTYPE, cfg.DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH = "float32", 0.0
    return cfg


def test_eval_only_plain_and_tta_tests_match_jax(nusc_root, tmp_path, monkeypatch):
    """EVAL_ONLY: metrics.jsonl holds the plain test's nuscenes/ results and
    then the tta/ results. Fed the port's detections (the plain test's,
    aggregated on the serving path; the TTA test's merged ones, before
    aggregation), the JAX package's do_test and _do_test_tta compute the same
    results, JAX aggregating the TTA samples itself, and the same TTA
    submission."""
    import scripts.train as jax_train
    from dd3d_tpu.models import postprocess as jax_postprocess
    from dd3d_tpu.models import tta as jax_tta
    from dd3d_tpu_torch.evaluators import nuscenes as pev
    from dd3d_tpu_torch.models import tta as port_tta

    processed, merged = [], []
    real_process, real_infer = pev.NuscenesEvaluator.process, port_tta.DD3DWithTTA.infer_batch

    def recorded_process(self, per_image, poses=None):
        processed.append([dict(d) for d in per_image])
        return real_process(self, per_image, poses)

    def recorded_infer(self, images, intrinsics):
        out = real_infer(self, images, intrinsics)
        merged.append([dict(d) for d in out])
        return out

    monkeypatch.setattr(pev.NuscenesEvaluator, "process", recorded_process)
    monkeypatch.setattr(port_tta.DD3DWithTTA, "infer_batch", recorded_infer)
    with torch_threads(4):
        run_dir = train_cli.main(cli_args(nusc_root, str(tmp_path / "port")))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [{k: v for k, v in json.loads(line).items() if k not in ("step", "ts")} for line in f]
    assert len(rows) == 2 and "nuscenes/NDS" in rows[0] and "tta/nuscenes/NDS" in rows[1]
    # two plain batches of 12 (2 samples each); the TTA test's 2 chunks of 12, handed over a sample at a time
    assert [len(p) for p in processed] == [12, 12, 6, 6, 6, 6] and [len(m) for m in merged] == [12, 12]
    assert {"quat_global", "attributes", "speeds"} <= set(processed[0][0])  # aggregated on the serving path
    with open(os.path.join(run_dir, "nusc_submission.json")) as f:
        port_tta_sub = json.load(f)  # the TTA test's: it writes after the plain test

    def replay(model, cfg, variables, loader, evaluators, **kwargs):
        for ev in evaluators:
            ev.reset()
            for batch in processed[:2]:
                ev.process([dict(d) for d in batch])
        out = {}
        for ev in evaluators:
            out.update(ev.evaluate())
        return out

    class Replay(jax_tta.NuscenesDD3DWithTTA):
        """The port's merged detections of each chunk; JAX's own sample aggregation."""

        def __init__(self, cfg, model, variables):
            self.bev_nms_iou_thresh = cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH
            self.chunks = iter(merged)

        def infer_batch(self, images, intrinsics):
            assert [im.shape for im in images] == [(90, 160, 3)] * 12
            return [{k: v for k, v in d.items() if k not in ("quat_global", "tvec_global")} for d in next(self.chunks)]

    monkeypatch.setattr(jax_postprocess, "inference_on_dataset", replay)
    monkeypatch.setattr(jax_tta, "NuscenesDD3DWithTTA", Replay)
    jcfg = jax_cfg(nusc_root, str(tmp_path / "jax"))
    state = types.SimpleNamespace(params=None, batch_stats=None)
    jax_dir = str(tmp_path / "jax_out")
    plain = jax_train.do_test(jcfg, None, jax_dir, state=state)
    tta = jax_train.do_test(jcfg, None, jax_dir, state=state, use_tta=True)
    assert_identical(rows[0], train_cli.flatten_results(plain))
    assert_identical(rows[1], train_cli.flatten_results(tta))
    with open(os.path.join(jax_dir, "nusc_submission.json")) as f:
        assert port_tta_sub == json.load(f)
