"""The port's evaluation slice against the JAX package's, on the CPU:

- the R40 engine's four native wrappers (dd3d_tpu_torch/evaluators/
  native.py over the port's own build of csrc/kitti_eval.cpp) against
  dd3d_tpu.evaluators.native on seeded boxes (identical, rotated,
  overlapping and disjoint ones): equal at tolerance 0, since both compile
  the same source with the same flags and every output element is computed
  by one thread in a fixed order (OpenMP splits rows only);
- the KITTI-3D and COCO-2D evaluators on the port's KITTI-format fixture
  with seeded detections (tests/torch_dist_workers.seeded_detections: AP
  neither 0 nor 100): results dicts identical to the JAX package's, with
  TEST.RANK0_METRICS, and on two gloo ranks against one process;
- get_evaluator's dispatch on the port's metadata;
- TestDataLoader: batches and meta byte-identical to the JAX package's,
  with one shard and with two;
- inference_on_dataset with converted weights on the fixture at a small
  test resize: per-image detections within test_torch_slice.py's
  tolerances of the JAX package's, and each side's detections give
  identical results through the other side's evaluators; its prediction
  drawings (visualize_dir) pixel for pixel the JAX package's.
"""
import json
import os

import jax
import numpy as np
import pytest

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment_cfg
from dd3d_tpu.data import register_datasets as jax_register_datasets
from dd3d_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from dd3d_tpu.evaluators import get_evaluator as jax_get_evaluator
from dd3d_tpu.evaluators import native as jax_native
from dd3d_tpu.evaluators.coco2d import COCO2DEvaluator as JaxCOCO2DEvaluator
from dd3d_tpu.evaluators.kitti_3d import KITTI3DEvaluator as JaxKITTI3DEvaluator
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.evaluators import get_evaluator, native
from dd3d_tpu_torch.evaluators.coco2d import COCO2DEvaluator
from dd3d_tpu_torch.evaluators.kitti_3d import KITTI3DEvaluator
from dd3d_tpu_torch.overfit_smoke import make_fixture
from tests.torch_dist_workers import eval_rank, register_fixture, seeded_detections
from tests.torch_port_util import assert_identical, run_gloo, torch_threads

DATASET = "kitti_3d_train"


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("kitti")), n_images=8)


def set_overrides(cfg, overrides):
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def both_cfgs(root, **overrides):
    """(JAX cfg, port cfg) of dd3d_kitti_dla34_overfit on the fixture, both
    registered with their own package's catalog."""
    overrides = {"DATASET_ROOT": root, **overrides}
    jcfg = set_overrides(jax_experiment_cfg("dd3d_kitti_dla34_overfit"), overrides)
    pcfg = set_overrides(get_experiment_cfg("dd3d_kitti_dla34_overfit"), overrides)
    jax_register_datasets(jcfg)
    register_fixture(root)
    return jcfg, pcfg


def evaluate(evaluator, dets):
    evaluator.reset()
    evaluator.process(dets)
    return evaluator.evaluate()


# --- the native engine ---------------------------------------------------------

def bev_cases(rng, n):
    """(N, 5) BEV boxes [cx, cy, dx, dy, angle] and (K, 5) query boxes: a
    random cloud, the same boxes, the same rotated by random angles and by
    pi/2, shifted into partial overlap, and far away."""
    q = np.concatenate([rng.uniform(-20, 20, (n, 2)), rng.uniform(0.5, 5, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))],
                       axis=1)
    rotated = q + np.array([0, 0, 0, 0, 1.0]) * rng.uniform(-np.pi, np.pi, (n, 1))
    quarter = q + np.array([0, 0, 0, 0, np.pi / 2])
    shifted = q + np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 3))], axis=1)
    far = q + np.array([1000.0, 1000.0, 0, 0, 0])
    return np.concatenate([q, rotated, quarter, shifted, far]), q


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_matrix_equals_jax(criterion):
    boxes, qboxes = bev_cases(np.random.RandomState(criterion + 1), 12)
    got = native.rotated_iou_matrix(boxes, qboxes, criterion)
    want = jax_native.rotated_iou_matrix(boxes, qboxes, criterion)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (60, 12) and 0 < (got > 0).mean() < 1
    np.testing.assert_array_equal(native.rotated_iou_matrix(boxes[:0], qboxes), np.zeros((0, 12)))


def boxes7(rng, bev):
    """(N, 7) camera-frame boxes [x, y, z, l, h, w, ry] on BEV boxes: y and
    height random, so vertical overlap is partial too."""
    return np.stack([bev[:, 0], rng.uniform(0, 2, len(bev)), bev[:, 1], bev[:, 2], rng.uniform(1, 2, len(bev)),
                     bev[:, 3], bev[:, 4]], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_d3_box_overlap_equals_jax(seed):
    rng = np.random.RandomState(seed)
    bev, qbev = bev_cases(rng, 10)
    b7, q7 = boxes7(rng, bev), boxes7(rng, qbev)
    b7[:10] = q7  # identical 3D boxes: IoU 1
    got = native.d3_box_overlap(b7, q7)
    np.testing.assert_array_equal(got, jax_native.d3_box_overlap(b7, q7))
    np.testing.assert_allclose(np.diag(got[:10]), 1.0, rtol=1e-12)


def matching_case(rng, n_images=6):
    """Per-image dt/gt counts, the overlap matrix of the shard's block layout
    (all dt x all gt, from d3_box_overlap; an image's detections are its
    ground truth moved by ~0.2 m and turned by ~0.1 rad, and random boxes), data rows (gt: bbox,
    rotation_y, alpha, dimensions; dt: the same + score) and ignore flags
    in {-1, 0, 1}, as KITTIEvaluationEngine._prepare_data lays them out."""
    gt_nums = rng.randint(1, 5, n_images)
    gt7, dt7, dt_nums = [], [], []
    for gn in gt_nums:
        g = boxes7(rng, bev_cases(rng, gn)[1])
        jittered = g + np.concatenate([rng.normal(0, 0.2, (gn, 1)), np.zeros((gn, 1)), rng.normal(0, 0.2, (gn, 1)),
                                       np.zeros((gn, 3)), rng.normal(0, 0.1, (gn, 1))], axis=1)
        d = np.concatenate([jittered, boxes7(rng, bev_cases(rng, 2)[1])])[rng.permutation(gn + 2)]
        d = d[:rng.randint(1, gn + 3)]
        gt7.append(g)
        dt7.append(d)
        dt_nums.append(len(d))
    gt7, dt7, dt_nums = np.concatenate(gt7), np.concatenate(dt7), np.asarray(dt_nums)
    overlaps = native.d3_box_overlap(dt7, gt7)

    def rows(n, extra):
        bbox = np.sort(rng.uniform(0, 300, (n, 4)).reshape(n, 2, 2), axis=1).reshape(n, 4)[:, [0, 2, 1, 3]]
        return np.concatenate([bbox, rng.uniform(-np.pi, np.pi, (n, 2)), rng.uniform(0.5, 4, (n, 3)),
                               rng.uniform(0, 1, (n, extra))], axis=1)

    def flags(n):
        return rng.choice([-1, 0, 1], n, p=[0.15, 0.7, 0.15])

    return overlaps, gt_nums, dt_nums, rows(len(gt7), 0), rows(len(dt7), 1), flags(len(gt7)), flags(len(dt7))


@pytest.mark.parametrize("min_overlap", [0.3, 0.5, 0.7])
def test_compute_threshold_equals_jax(min_overlap):
    overlaps, gt_nums, dt_nums, _, dt_data, ig_gt, ig_dt = matching_case(np.random.RandomState(int(min_overlap * 10)))
    n_thresholds = 0
    g0 = d0 = 0
    for gn, dn in zip(gt_nums, dt_nums):
        args = (overlaps[d0:d0 + dn, g0:g0 + gn], dt_data[d0:d0 + dn, -1], ig_gt[g0:g0 + gn], ig_dt[d0:d0 + dn],
                min_overlap)
        got = native.compute_threshold(*args)
        np.testing.assert_array_equal(got, jax_native.compute_threshold(*args))
        n_thresholds += len(got)
        g0, d0 = g0 + gn, d0 + dn
    assert n_thresholds > 0


@pytest.mark.parametrize("compute_angular", [True, False])
def test_fused_compute_statistics_equals_jax(compute_angular):
    overlaps, gt_nums, dt_nums, gt_data, dt_data, ig_gt, ig_dt = matching_case(np.random.RandomState(5))
    thresholds = np.sort(np.random.RandomState(6).uniform(0, 1, 9))[::-1]
    prs = []
    for fn in (native.fused_compute_statistics, jax_native.fused_compute_statistics):
        pr = np.zeros((len(thresholds), 8), dtype=np.float64)
        fn(overlaps, pr, gt_nums, dt_nums, gt_data, dt_data, ig_gt, ig_dt, min_overlap=0.5, thresholds=thresholds,
           compute_angular=compute_angular)
        prs.append(pr)
    np.testing.assert_array_equal(prs[0], prs[1])
    assert prs[0][:, 0].max() > 0 and prs[0][:, 1].max() > 0  # true and false positives counted


# --- the evaluators ------------------------------------------------------------

@pytest.mark.parametrize("rank0_only", [False, True])
def test_kitti3d_evaluator_equals_jax(fixture_root, tmp_path, rank0_only):
    both_cfgs(fixture_root)
    dets = seeded_detections(register_fixture(fixture_root))
    got = evaluate(KITTI3DEvaluator(DATASET, output_dir=str(tmp_path / "port"), rank0_only=rank0_only), dets)
    want = evaluate(JaxKITTI3DEvaluator(DATASET, output_dir=str(tmp_path / "jax"), rank0_only=rank0_only), dets)
    assert_identical(got, want)
    car = got["kitti_3d"]["kitti_box3d_r40/Car_Moderate_0.5"]
    assert 0 < car < 100 and got["kitti_3d"]["kitti_bev_r40/Car_Moderate_0.7"] < 100
    written = [json.loads((tmp_path / side / "kitti_predictions.json").read_text()) for side in ("port", "jax")]
    assert written[0] == written[1] and len(written[0]) == sum(len(d["classes"]) for d in dets)


def test_kitti3d_engine_on_jax_dataset_dicts(fixture_root):
    """The port's evaluator reads its own catalog's dicts: the same fixture
    through JAX's catalog gives the same ground truth rows."""
    both_cfgs(fixture_root)
    port = KITTI3DEvaluator(DATASET)
    jax_ev = JaxKITTI3DEvaluator(DATASET)
    dets = seeded_detections(JaxDatasetCatalog.get(DATASET))
    for ev in (port, jax_ev):
        ev.process(dets)
    assert port._groundtruth_kitti == jax_ev._groundtruth_kitti
    assert port._predictions_kitti == jax_ev._predictions_kitti


def test_coco2d_evaluator_equals_jax(fixture_root):
    both_cfgs(fixture_root)
    dets = seeded_detections(register_fixture(fixture_root))
    got = evaluate(COCO2DEvaluator(DATASET), dets)
    assert_identical(got, evaluate(JaxCOCO2DEvaluator(DATASET), dets))
    assert 0 < got["bbox"]["AP"] < 100 and 0 < got["bbox"]["AP-Car"] < 100


@pytest.mark.parametrize("rank0_only", [False, True])
def test_two_gloo_ranks_equal_one_process(fixture_root, tmp_path, rank0_only):
    """Each rank processes its InferenceSampler shard; the gathered results
    (KITTI-3D with and without TEST.RANK0_METRICS, COCO-2D) on both ranks
    and rank 0's JSON predictions equal one JAX process over all images."""
    both_cfgs(fixture_root)
    dets = seeded_detections(register_fixture(fixture_root))
    ranks = run_gloo(eval_rank, 2, fixture_root, rank0_only, str(tmp_path / "json"), out_dir=tmp_path / "ranks")
    want = [evaluate(JaxKITTI3DEvaluator(DATASET, output_dir=str(tmp_path / "jax")), dets),
            evaluate(JaxCOCO2DEvaluator(DATASET), dets)]
    assert [r["n_local"] for r in ranks] == [4, 4]
    for rank, r in enumerate(ranks):
        for got, w in zip(r["results"], want):
            assert_identical(got, w, f"rank {rank}")
    assert ranks[1]["written"] is None
    assert ranks[0]["written"] == json.loads((tmp_path / "jax" / "kitti_predictions.json").read_text())


def test_get_evaluator_dispatch(fixture_root):
    from dd3d_tpu_torch.data.catalog import MetadataCatalog

    jcfg, pcfg = both_cfgs(fixture_root, **{"TEST.RANK0_METRICS": True})
    got = get_evaluator(pcfg, DATASET, output_dir="out")
    want = jax_get_evaluator(jcfg, DATASET, output_dir="out")
    assert [type(e).__name__ for e in got] == [type(e).__name__ for e in want] == ["COCO2DEvaluator",
                                                                                   "KITTI3DEvaluator"]
    assert got[1]._rank0_only and got[1]._iou_thresholds == want[1]._iou_thresholds == [0.5, 0.7]
    MetadataCatalog.get("nusc_fake")["evaluators"] = ("nuscenes_evaluator",)
    (nusc,) = get_evaluator(pcfg, "nusc_fake", output_dir="out")
    assert type(nusc).__name__ == "NuscenesEvaluator" and nusc._rank0_only and nusc._output_dir == "out"
    MetadataCatalog.get("unknown_fake")["evaluators"] = ("bogus",)
    with pytest.raises(KeyError, match="bogus"):
        get_evaluator(pcfg, "unknown_fake")


# --- the test loader -----------------------------------------------------------

@pytest.mark.parametrize("shard_idx,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_test_loader_batches_equal_jax(fixture_root, shard_idx, num_shards):
    """Batches of 3 (ragged: the shard's last is smaller) at the test
    resize, short side 384: every array and the meta byte-identical."""
    from dd3d_tpu.data.build import TestDataLoader as JaxTestDataLoader
    from dd3d_tpu_torch.data.build import TestDataLoader

    o = {"TEST.IMS_PER_BATCH": 3, "DATALOADER.TEST.NUM_WORKERS": 2}
    jcfg, pcfg = both_cfgs(fixture_root, **o)
    kw = dict(dataset_name="kitti_3d_overfit", shard_idx=shard_idx, num_shards=num_shards)
    got, want = list(TestDataLoader(pcfg, **kw)), list(JaxTestDataLoader(jcfg, **kw))
    assert len(got) == len(want) == len(TestDataLoader(pcfg, **kw)) == (3 if num_shards == 1 else 2)
    ids = []
    for (batch, meta), (jbatch, jmeta) in zip(got, want):
        assert list(batch) == list(jbatch)
        for k, v in jbatch.items():
            assert batch[k].dtype == v.dtype and batch[k].shape == v.shape and batch[k].tobytes() == v.tobytes(), k
        assert meta == jmeta
        ids += [m["image_id"] for m in meta]
    assert got[0][0]["image"].shape[1:] == (384, 1280, 3)
    assert ids == [f"{i:06d}_camera_2" for i in np.array_split(np.arange(8), num_shards)[shard_idx]]


# --- inference_on_dataset ------------------------------------------------------

class Recorder:
    """An evaluator that keeps the per-image dicts it is given."""

    def reset(self):
        self.dets = []

    def process(self, per_image):
        self.dets += per_image

    def evaluate(self):
        return {}


@pytest.fixture(scope="module")
def inference_runs(fixture_root):
    """inference_on_dataset of both packages over their own test loaders of
    the fixture (8 images, batch 4, test resize 96: canvas 128x384), fp32,
    the same converted `detection_state_dict` weights, the top 20
    detections an image; each run's per-image dicts and results."""
    from dd3d_tpu.models.postprocess import inference_on_dataset as jax_inference_on_dataset
    from dd3d_tpu.data.build import TestDataLoader as JaxTestDataLoader
    from dd3d_tpu_torch.data.build import TestDataLoader
    from dd3d_tpu_torch.models.postprocess import inference_on_dataset
    from tests.torch_port_util import both_models, detection_state_dict

    o = {"TPU.COMPUTE_DTYPE": "float32", "DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK": 20, "TEST.IMS_PER_BATCH": 4,
         "INPUT.RESIZE.MIN_SIZE_TEST": 96, "DATALOADER.TEST.NUM_WORKERS": 2}
    jcfg, pcfg = both_cfgs(fixture_root, **o)
    jm, variables, pm = both_models(jcfg, detection_state_dict())
    name = pcfg.DATASETS.TEST.NAME
    rec_p, rec_j = Recorder(), Recorder()
    with torch_threads(4):
        res_p = inference_on_dataset(pm, pcfg, TestDataLoader(pcfg), get_evaluator(pcfg, name) + [rec_p])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "local_device_count", lambda: 1)  # one device: no batch sharding, as on one card
    try:
        res_j = jax_inference_on_dataset(jm, jcfg, variables, JaxTestDataLoader(jcfg),
                                         jax_get_evaluator(jcfg, name) + [rec_j])
    finally:
        mp.undo()
    return {"port": (rec_p.dets, res_p), "jax": (rec_j.dets, res_j), "cfgs": (jcfg, pcfg), "name": name}


def test_inference_on_dataset_detections_match_jax(inference_runs):
    """Per image: the same ids, 20 detections in the same order, classes and
    FPN levels, the 3D and score fields within 1e-3 (relative 1e-4), the 2D
    boxes within 1e-3 at the network's input resolution (unpack_detections
    rescales them to the 375x1242 frame, x ~3.9)."""
    got, want = inference_runs["port"][0], inference_runs["jax"][0]
    assert [d["image_id"] for d in got] == [d["image_id"] for d in want] == [f"{i:06d}_camera_2" for i in range(8)]
    for p, j in zip(got, want):
        # order is well defined: neighbouring scores lie further apart than
        # five times the two sides' largest difference (gaps >= 7e-6 here,
        # differences <= 1e-6)
        assert len(p["scores_3d"]) == len(j["scores_3d"]) == 20
        assert np.diff(j["scores_3d"]).max() < -5 * np.abs(p["scores_3d"] - j["scores_3d"]).max()
        np.testing.assert_array_equal(p["classes"], j["classes"])
        np.testing.assert_array_equal(p["fpn_levels"], j["fpn_levels"])
        for key in ("scores", "scores_3d", "quat", "tvec", "size", "conf3d"):
            np.testing.assert_allclose(p[key], j[key], atol=1e-3, rtol=1e-4, err_msg=key)
        scale = 375 / 96  # the frame over the resized image
        np.testing.assert_allclose(p["boxes2d"], j["boxes2d"], atol=1e-3 * scale, rtol=1e-4, err_msg="boxes2d")


@pytest.mark.parametrize("side", ["port", "jax"])
def test_detections_give_identical_results_on_both_evaluators(inference_runs, side):
    """One side's detections through the port's and JAX's evaluators:
    identical results; the run's own results are those of its evaluators."""
    jcfg, pcfg = inference_runs["cfgs"]
    dets, results = inference_runs[side]
    name = inference_runs["name"]
    got = {k: v for ev in get_evaluator(pcfg, name) for k, v in evaluate(ev, dets).items()}
    want = {k: v for ev in jax_get_evaluator(jcfg, name) for k, v in evaluate(ev, dets).items()}
    assert_identical(got, want)
    assert_identical(results, got if side == "port" else want)
    assert set(got) == {"bbox", "kitti_3d"} and all(np.isfinite(v) for v in got["kitti_3d"].values())


def test_visualize_dir_draws_what_jax_draws(fixture_root, tmp_path, monkeypatch):
    """inference_on_dataset(visualize_dir=..., max_vis=5) over batches of 4:
    the first five images' pred_<image_id>.png, pixel for pixel what the
    JAX package's inference_on_dataset draws (with cv2) from the same
    detections (its inference function stubbed to return the port's)."""
    import cv2

    import dd3d_tpu.models.postprocess as jax_postprocess
    from dd3d_tpu.data.build import TestDataLoader as JaxTestDataLoader
    from dd3d_tpu_torch.data.build import TestDataLoader
    from dd3d_tpu_torch.data.imageio import read_image_bgr
    from dd3d_tpu_torch.models.postprocess import get_inference_fn, inference_on_dataset
    from tests.torch_port_util import both_models, detection_state_dict

    o = {"TPU.COMPUTE_DTYPE": "float32", "TEST.IMS_PER_BATCH": 4, "INPUT.RESIZE.MIN_SIZE_TEST": 96,
         "DATALOADER.TEST.NUM_WORKERS": 2}
    jcfg, pcfg = both_cfgs(fixture_root, **o)
    _, _, pm = both_models(jcfg, detection_state_dict())
    with torch_threads(4):
        inference_on_dataset(pm, pcfg, TestDataLoader(pcfg), [], visualize_dir=str(tmp_path / "port"), max_vis=5)
        infer = get_inference_fn(pm, pcfg)
        monkeypatch.setattr(jax_postprocess, "get_inference_fn", lambda *a, **k: (
            lambda variables, images, intrinsics: {key: v.numpy() for key, v in infer(images, intrinsics).items()}))
        monkeypatch.setattr(jax, "local_device_count", lambda: 1)
        jax_postprocess.inference_on_dataset(None, jcfg, None, JaxTestDataLoader(jcfg), [],
                                             visualize_dir=str(tmp_path / "jax"), max_vis=5)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [f"pred_{i:06d}_camera_2.png" for i in range(5)]
    for name in names:
        got = read_image_bgr(str(tmp_path / "port" / name))
        assert got.shape == (96, 318, 3)  # the network input, 375x1242 resized to short side 96
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "jax" / name)))


def test_loader_exception_reaches_the_caller(fixture_root):
    """The producer thread hands a loader's exception to the consumer."""
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.postprocess import inference_on_dataset

    def broken_loader():
        raise OSError("unreadable frame")
        yield  # a generator

    _, pcfg = both_cfgs(fixture_root)
    with pytest.raises(OSError, match="unreadable frame"):
        inference_on_dataset(build_model(pcfg), pcfg, broken_loader(), [Recorder()])


def test_a_failed_engine_build_raises(tmp_path, monkeypatch):
    """The engine is built from the port's own source with g++ -fopenmp; a
    source that does not compile raises (no prebuilt library stands in)."""
    import dd3d_tpu_torch.kernels as kernels

    assert kernels.GXX_FLAGS == ("-O3", "-fopenmp", "-shared", "-fPIC")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "kitti_eval.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(kernels, "_PKG", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernels, "_LOADED", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on .*kitti_eval.cpp"):
        native.rotated_iou_matrix(np.ones((1, 5)), np.ones((1, 5)))
    assert not [f for f in os.listdir(tmp_path / "_build") if f.endswith(".so")]


def test_native_wrappers_refuse_mismatched_shapes():
    """The engine reads raw pointers: each wrapper checks its shapes first."""
    overlaps, gt_nums, dt_nums, gt_data, dt_data, ig_gt, ig_dt = matching_case(np.random.RandomState(5))
    with pytest.raises(ValueError):
        native.rotated_iou_matrix(np.ones((2, 4)), np.ones((2, 5)))
    with pytest.raises(ValueError):
        native.d3_box_overlap(np.ones((2, 7)), np.ones((2, 5)))
    with pytest.raises(ValueError):
        native.compute_threshold(np.ones((3, 2)), np.ones(2), np.zeros(2), np.zeros(3), 0.5)
    pr = np.zeros((4, 8))
    with pytest.raises(ValueError):
        native.fused_compute_statistics(overlaps, pr, gt_nums, dt_nums, gt_data, dt_data[:-1], ig_gt, ig_dt, 0.5,
                                        np.linspace(1, 0, 4))
