"""The whole serving slice: uint8 images in, fixed-size detections out,
through the JAX `get_inference_fn` and the port's `get_inference_fn` with
the same converted weights, at 128x256, batch 2, fp32; plus the port's
independence from jax and its CLI.

Detections must agree in number, classes and order. Boxes, scores and 3D
fields are within 1e-3 (absolute, relative 1e-4): the head outputs differ by
about 2e-6 (tests/test_torch_model.py) and the decode amplifies that at most
by the box and depth scales (strides up to 128, depths up to 80 m).

Order is only defined where scores are apart: with random weights, scores
deep in a 100-long list sit ~1e-6 apart, as close as the two frameworks'
score differences. So the weights are `detection_state_dict` (features that
carry the image, boxes that overlap) and the comparison keeps the top 20
detections per image, whose neighbouring scores are asserted to be more than
1e-4 apart.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu_torch.models.postprocess import get_inference_fn, unpack_detections

from tests.torch_port_util import both_models, detection_state_dict, fp32_cfg, torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def detections():
    cfg = fp32_cfg()
    cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    jm, variables, pm = both_models(cfg, detection_state_dict())
    images = (np.random.RandomState(4).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    det_j = jax_get_inference_fn(jm, cfg)(variables, jnp.asarray(images), jnp.asarray(intrinsics))
    det_p = get_inference_fn(pm, cfg)(images, intrinsics)
    return {k: np.asarray(v) for k, v in det_j.items()}, det_p, intrinsics


def test_slice_matches_jax(detections):
    det_j, det_p, _ = detections
    det_p = {k: v.numpy() for k, v in det_p.items()}
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.all()
    assert np.diff(det_j["scores_3d"], axis=1).max() < -1e-4  # order is well defined
    np.testing.assert_array_equal(det_p["classes"][valid], det_j["classes"][valid])
    np.testing.assert_array_equal(det_p["fpn_levels"][valid], det_j["fpn_levels"][valid])
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], atol=1e-3, rtol=1e-4, err_msg=key)


def test_unpack_detections(detections):
    _det_j, det_p, intrinsics = detections
    batch = {"intrinsics": intrinsics, "image_size": np.array([[128, 256], [128, 256]])}
    meta = [{"image_id": "a", "width": 512, "height": 256}, {"image_id": "b"}]
    rows = unpack_detections(det_p, batch, meta)
    valid = det_p["valid"].numpy()
    assert [r["image_id"] for r in rows] == ["a", "b"]
    assert len(rows[0]["scores"]) == valid[0].sum()
    np.testing.assert_allclose(rows[0]["boxes2d"][:, 0::2].max(), min(512, 2 * det_p["boxes2d"][0][valid[0]][:, 0::2].max()))
    assert rows[1]["boxes3d_vec"].shape == (valid[1].sum(), 10)


@pytest.mark.parametrize("min_size,max_size", [(384, 100000), ([96, 200], 100000), (256, 300)])
def test_iter_batches_matches_jax_mapper(tmp_path, monkeypatch, min_size, max_size):
    """Three PNGs at odd sizes (one portrait) through the port's
    `iter_batches` (its own copy of the inference mapper and collate) and
    through the JAX package's DatasetMapper + collate_batch with the native
    decoder off (as tests/test_native_imageio.py does): byte-identical
    batches (image, intrinsics, image size, canvas, the GT padding) and
    meta. Cases: the test resize of dd3d_kitti_dla34, two sizes drawn from
    the same seeded stream, and a longest edge clamped by MAX_SIZE_TEST."""
    import cv2

    from dd3d_tpu.data import native
    from dd3d_tpu.data.augmentations import build_augmentation
    from dd3d_tpu.data.mapper import DatasetMapper, collate_batch
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.predict import iter_batches, read_image_dicts

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert not native.available()
    rng = np.random.RandomState(3)
    files = []
    for i, (h, w) in enumerate([(100, 330), (77, 151), (203, 97)]):
        files.append(str(tmp_path / f"{i:06d}.png"))
        cv2.imwrite(files[-1], rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.INPUT.RESIZE.MAX_SIZE_TEST = min_size, max_size
    dicts = read_image_dicts(files, KITTI_K.astype(np.float64))

    (chunk, batch, meta), = iter_batches(cfg, dicts, 3)
    mapper = DatasetMapper(build_augmentation(cfg, is_train=False), is_train=False, box3d_on=True)
    map_rng = np.random.RandomState(0)
    want, want_meta = collate_batch([mapper(d, map_rng) for d in dicts], max_gt=1, size_divisibility=128)
    assert chunk == dicts and list(batch) == list(want)
    for k, v in want.items():
        assert batch[k].dtype == v.dtype and batch[k].shape == v.shape, k
        assert batch[k].tobytes() == v.tobytes(), k
    assert meta == want_meta
    assert batch["image_size"].max() > 100  # the images were resized


def test_port_runs_without_jax(tmp_path):
    """Build the port's model and run bf16 inference, then calibrate and serve
    static int8 with bench.py's overrides, then the same for dd3d_kitti_v99
    (VoVNet, FPN P3-P6; a depthwise preset), then take a bf16 train step through
    `train` with the stem's weight gradient routed to its kernel, then map
    and collate a PNG through `predict.iter_batches`, then write the port's
    KITTI fixture and take one batch of its train loader, then run the
    native R40 engine and the KITTI-3D and COCO-2D evaluators on the
    fixture, then run test-time augmentation and draw with every
    visualizer, then run dd3d_nusc_dla34's plain test (the sample
    aggregation, the nuScenes evaluator) and its TTA test on a one-sample
    6-camera fixture, in a fresh interpreter: no jax or flax module, and nothing of
    the JAX package `dd3d_tpu`, may be imported on the way, the JAX
    package's engine library (dd3d_tpu/evaluators/native/libkitti_eval.so)
    must not be mapped, only the port's own build, and cv2 and PIL are
    blocked (the
    GPU machine has neither jax nor cv2; the port keeps its own copy of what
    it needs and reads images itself)."""
    import cv2

    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, np.random.RandomState(0).randint(0, 256, (90, 250, 3), dtype=np.uint8))
    code = (
        "import sys\n"
        "sys.modules['cv2'] = sys.modules['PIL'] = None  # importing either raises ImportError\n"
        "import torch\n"
        "from dd3d_tpu_torch.configs import get_experiment_cfg\n"
        "from dd3d_tpu_torch.models import build_model\n"
        "from dd3d_tpu_torch.models.calibrate import prepare_static_scales\n"
        "from dd3d_tpu_torch.models.postprocess import get_inference_fn\n"
        "cfg = get_experiment_cfg('dd3d_kitti_dla34')\n"
        "model = build_model(cfg, generator=torch.Generator().manual_seed(0))\n"
        "images = torch.randint(0, 256, (1, 128, 256, 3), dtype=torch.uint8)\n"
        "det = get_inference_fn(model, cfg)(images, torch.eye(3)[None])\n"
        "assert det['boxes2d'].shape == (1, 100, 4)\n"
        "cfg.TPU.QUANT_INT8, cfg.TPU.QUANT_MIN_CH, cfg.TPU.QUANT_UNFOLDED = True, 32, True\n"
        "infer = get_inference_fn(model, prepare_static_scales(cfg, model, [images]))\n"
        "det = infer(images, torch.eye(3)[None])\n"
        "assert det['boxes2d'].shape == (1, 100, 4) and not infer.quant.misses\n"
        "vcfg = get_experiment_cfg('dd3d_kitti_v99')\n"
        "vcfg.FE.BACKBONE.NAME = 'V-19-slim-dw-eSE'\n"
        "vmodel = build_model(vcfg, generator=torch.Generator().manual_seed(0))\n"
        "assert vmodel.strides == (8, 16, 32, 64)\n"
        "det = get_inference_fn(vmodel, vcfg)(images, torch.eye(3)[None])\n"
        "assert det['boxes2d'].shape == (1, 100, 4)\n"
        "vcfg.TPU.QUANT_INT8, vcfg.TPU.QUANT_MIN_CH = True, 32\n"
        "infer = get_inference_fn(vmodel, prepare_static_scales(vcfg, vmodel, [images]))\n"
        "assert infer(images, torch.eye(3)[None])['boxes2d'].shape == (1, 100, 4) and not infer.quant.misses\n"
        "import numpy as np\n"
        "from dd3d_tpu_torch.training.synthetic import synthetic_batch\n"
        "from dd3d_tpu_torch.training.train_loop import train\n"
        "cfg = get_experiment_cfg('dd3d_kitti_dla34')\n"
        "cfg.TPU.PALLAS_STEM_DW = True\n"
        "model = build_model(cfg, generator=torch.Generator().manual_seed(0))\n"
        "assert model.backbone.bottom_up.base_layer.kernel_weight_grad\n"
        "seen = []\n"
        "batches = [synthetic_batch(np.random.RandomState(0), 1, 128, 128)]\n"
        "state = train(cfg, batches, model=model, device='cpu', max_iter=1, metric_hook=lambda i, m: seen.append(m))\n"
        "assert state.step == 1 and seen[0]['loss_finite'] == 1.0, seen\n"
        "from dd3d_tpu_torch.predict import iter_batches, read_image_dicts\n"
        f"dicts = read_image_dicts([{png!r}], np.eye(3))\n"
        "(_, batch, meta), = iter_batches(cfg, dicts, 1)\n"
        "assert batch['image'].shape == (1, 384, 1152, 3) and batch['image_size'].tolist() == [[384, 1067]]\n"
        "from dd3d_tpu_torch.overfit_smoke import make_fixture\n"
        "from dd3d_tpu_torch.data.build import TrainDataLoader\n"
        "from dd3d_tpu_torch.data.catalog import register_datasets\n"
        "cfg = get_experiment_cfg('dd3d_kitti_dla34_overfit')\n"
        f"cfg.DATASET_ROOT = make_fixture({str(tmp_path / 'kitti')!r}, n_images=2)\n"
        "cfg.INPUT.RESIZE.MIN_SIZE_TRAIN, cfg.SOLVER.IMS_PER_BATCH = [96], 2\n"
        "cfg.DATALOADER.TRAIN.USE_PROCESS_POOL, cfg.DATALOADER.TRAIN.NUM_WORKERS = False, 2\n"
        "register_datasets(cfg)\n"
        "it = iter(TrainDataLoader(cfg))\n"
        "batch, meta = next(it)\n"
        "it.close()\n"
        "assert batch['image'].shape == (2, 128, 384, 3) and batch['gt_valid'].any(), batch['image'].shape\n"
        "from dd3d_tpu_torch.data.catalog import DatasetCatalog\n"
        "from dd3d_tpu_torch.evaluators import get_evaluator\n"
        "from dd3d_tpu_torch.evaluators.native import d3_box_overlap\n"
        "box = np.array([[0.0, 1.0, 10.0, 4.0, 1.5, 1.6, 0.1]])\n"
        "assert d3_box_overlap(box, box)[0, 0] > 1 - 1e-12\n"
        "empty = {'classes': np.zeros(0, int), 'scores': np.zeros(0), 'scores_3d': np.zeros(0),\n"
        "         'boxes2d': np.zeros((0, 4)), 'quat': np.zeros((0, 4)), 'tvec': np.zeros((0, 3)), 'size': np.zeros((0, 3))}\n"
        "evaluators = get_evaluator(cfg, 'kitti_3d_train')\n"
        "for ev in evaluators:\n"
        "    ev.process([{'image_id': d['image_id'], **empty} for d in DatasetCatalog.get('kitti_3d_train')])\n"
        "results = [ev.evaluate() for ev in evaluators]\n"
        "assert results[1]['kitti_3d']['kitti_box3d_r40/Car_Moderate_0.5'] == 0.0, results\n"
        "from dd3d_tpu_torch.models.tta import DD3DWithTTA\n"
        "from dd3d_tpu_torch.visualizers import get_dataloader_visualizer, get_predictions_visualizer\n"
        "from dd3d_tpu_torch.visualizers.draw import save_vis\n"
        "tcfg = get_experiment_cfg('dd3d_kitti_dla34')\n"
        "tcfg.TEST.AUG.MIN_SIZES, tcfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = [64], 5\n"
        "tmodel = build_model(tcfg, generator=torch.Generator().manual_seed(0))\n"
        "tta = DD3DWithTTA(tcfg, tmodel)\n"
        "frame = np.random.RandomState(1).randint(0, 256, (70, 200, 3)).astype(np.uint8)\n"
        "merged, = tta.infer_batch([frame], [np.eye(3) * 100])\n"
        "assert len(merged['scores_3d']) == 5 and dict(tta.stats['buckets']) == {(128, 256): 2}, merged\n"
        "sample = TrainDataLoader(cfg).mapper(DatasetCatalog.get('kitti_3d_train')[0], np.random.RandomState(0))\n"
        "for name in ('d2_visualizer', 'box3d_visualizer'):\n"
        f"    save_vis(get_dataloader_visualizer(cfg, name, 'kitti_3d_train').visualize(sample), {str(tmp_path / 'vis')!r}, name)\n"
        "det = dict(merged, scores=merged['scores'] * 0 + 1, scores_3d=merged['scores_3d'] * 0 + 1)\n"
        "assert get_predictions_visualizer(cfg, 'box3d_visualizer', 'kitti_3d_train', '').visualize(\n"
        "    frame, det, np.eye(3) * 100).shape == (1002, 2004, 3)\n"
        "from dd3d_tpu_torch.models.tta import NuscenesDD3DWithTTA\n"
        "from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture\n"
        "from dd3d_tpu_torch.train import do_test\n"
        "import dd3d_tpu_torch.evaluators.nuscenes, dd3d_tpu_torch.ops.sample_bev_nms, dd3d_tpu_torch.models.cross_camera\n"
        "ncfg = get_experiment_cfg('dd3d_nusc_dla34')\n"
        f"ncfg.DATASET_ROOT = make_nusc_fixture({str(tmp_path / 'nusc')!r}, n_samples=1, height=60, width=100)\n"
        "ncfg.DATASETS.TEST.NAME, ncfg.INPUT.RESIZE.MIN_SIZE_TEST = NUSC_FIXTURE, 64\n"
        "ncfg.TEST.AUG.MIN_SIZES, ncfg.TPU.COMPUTE_DTYPE = [64], 'float32'\n"
        "register_datasets(ncfg)\n"
        "nmodel = build_model(ncfg, generator=torch.Generator().manual_seed(0))\n"
        f"plain = do_test(ncfg, nmodel, {str(tmp_path / 'nusc_out')!r})\n"
        f"tta = do_test(ncfg, nmodel, {str(tmp_path / 'nusc_out')!r}, use_tta=True)\n"
        "assert 'NDS' in plain['nuscenes'] and 'tta/nuscenes' in tta, (plain, tta)\n"
        "import os\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libkitti_eval_' in maps and os.path.join('dd3d_tpu', 'evaluators') not in maps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dd3d_tpu')\n"
        "             or (m.split('.')[0] in ('cv2', 'PIL') and sys.modules[m] is not None))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "2"}  # test files run in parallel processes
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0 and proc.stdout.strip().splitlines()[-1] == "ok", proc.stderr[-3000:]


def test_predict_cli_writes_json(tmp_path):
    """`python -m dd3d_tpu_torch.predict` on two synthetic PNGs."""
    import cv2

    rng = np.random.RandomState(0)
    for i in range(2):
        cv2.imwrite(str(tmp_path / f"{i:06d}.png"), (rng.rand(100, 330, 3) * 255).astype(np.uint8))
    out = tmp_path / "preds.json"
    cmd = [sys.executable, "-m", "dd3d_tpu_torch.predict", "--experiment", "dd3d_kitti_dla34",
           "--images", str(tmp_path), "--intrinsics", "721.5,721.5,609.5,172.8", "--out", str(out),
           "--device", "cpu", "--batch", "2", "INPUT.RESIZE.MIN_SIZE_TEST=128"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = json.loads(out.read_text())
    assert [r["image_id"] for r in records] == ["000000", "000001"]
    for r in records:
        assert len(r["scores"]) == len(r["boxes2d"]) == len(r["quat"]) > 0
        assert all(0 <= b[0] <= b[2] <= 330 and 0 <= b[1] <= b[3] <= 100 for b in r["boxes2d"])


def test_sample_aggregation_is_not_ported():
    """With DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE the serving function at group
    size 1, or without poses, gives the plain detections; at group size 2
    with poses, each pair of images (here one image twice) is one sample
    whose detections go through one global BEV NMS (a strict subset of the
    plain ones; at random weights some boxes are too thin for a nonzero
    f32 IoU with their copy, so not all copies go) and carry
    global-frame boxes, offset by the pose's translation."""
    from dd3d_tpu_torch.models import build_model

    with torch_threads(2):  # test files run in parallel processes
        _check_sample_aggregation(build_model)


def _check_sample_aggregation(build_model):
    cfg = fp32_cfg()
    cfg.DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE = True
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    images = np.repeat((np.random.RandomState(1).rand(1, 128, 256, 3) * 255).astype(np.uint8), 2, axis=0)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    pose_quat, pose_tvec = np.float32([[1, 0, 0, 0]] * 2), np.float32([[5, 6, 7]] * 2)
    plain = get_inference_fn(model, cfg)(images, intrinsics)
    for det in (get_inference_fn(model, cfg)(images, intrinsics, pose_quat, pose_tvec),
                get_inference_fn(model, cfg, group_size=2)(images, intrinsics)):
        assert set(det) == set(plain) and all(torch.equal(det[k], plain[k]) for k in det)
    agg = get_inference_fn(model, cfg, group_size=2)(images, intrinsics, pose_quat, pose_tvec)
    assert set(agg) == set(plain) | {"quat_global", "tvec_global"}
    assert 0 < int(agg["valid"].sum()) < int(plain["valid"].sum())  # copies of the other camera's boxes suppressed
    assert not (agg["valid"] & ~plain["valid"]).any()
    torch.testing.assert_close(agg["quat_global"], plain["boxes3d_quat"], rtol=0, atol=1e-6)  # identity rotation

