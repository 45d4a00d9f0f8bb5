"""Test-time augmentation of the port (dd3d_tpu_torch/models/tta.py) against
the JAX package's (dd3d_tpu/models/tta.py), on the CPU in fp32 with the same
converted weights (`detection_state_dict`: scores that do not tie), four
uint8 frames of different sizes, one of them a full KITTI frame (375x1242
with KITTI's intrinsics, which the flip mirrors about x = 1242), min_sizes
[96, 128] with flip: three canvas buckets, (128, 384), (128, 256) and
(128, 512), of eight, six and two instances.

- the variant sizes and the bucket layout are JAX's, for several frame
  sizes and MAX_SIZE caps; the unflip and the merge NMS are JAX's functions
  at tolerance 0 on seeded arrays with ties;
- bf16 path, run here in fp32: the merged detections of each image have the
  same classes, and boxes, scores and 3D fields within atol 1e-3, rtol 1e-4
  (the single-pass bound of tests/test_torch_slice.py: the TTA merge only
  selects among those detections and rescales them);
- static int8: the same buckets are calibrated, in the same order; the
  merged scales have the same keys and tags and agree within 5e-2 relative
  (the bound of tests/test_torch_calibrate.py, whose docstring gives its
  source: XLA's fused dequant rounds 1 ulp off, compounded over ~30 convs);
  a QUANT_SCALES_PATH seed merges as JAX merges it; no scale misses; the
  detections are held as tests/test_torch_int8.py holds static int8: a
  bucket's static forward, calibrated on that batch, equals the dynamic
  int8 forward of the same canvas bit for bit; against JAX, each image's
  merged scores_3d, sorted, agree within 2e-2;
- a bucket's int8 conv beyond the kernel's 2^31 elements is launched on
  runs of images that cover the batch.
"""
import json

import numpy as np
import pytest
import torch

from dd3d_tpu.models import tta as jtta
from dd3d_tpu_torch.models import tta as ptta

from tests.torch_port_util import both_models, detection_state_dict, fp32_cfg, jax_quant_globals_restored, torch_threads

KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float64)
SIZES = [(90, 250), (100, 260), (120, 200), (375, 1242)]
MIN_SIZES = [96, 128]
FIELDS = ("boxes2d", "scores", "scores_3d", "quat", "tvec", "size", "conf3d")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def tta_cfg(int8=False):
    cfg = fp32_cfg()
    cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    cfg.TEST.AUG.MIN_SIZES = MIN_SIZES
    if int8:
        cfg.TPU.QUANT_INT8 = True
        cfg.TPU.QUANT_MIN_CH = 32
        cfg.TPU.QUANT_UNFOLDED = True
    return cfg


def frames():
    rng = np.random.RandomState(5)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in SIZES]
    ks = [KITTI_K * np.array([[w / 1242], [h / 375], [1.0]]) for h, w in SIZES]
    return images, ks


@pytest.fixture(scope="module")
def models():
    return both_models(tta_cfg(), detection_state_dict())


def run_jax(cfg, jm, variables, images, ks):
    with jax_quant_globals_restored():
        tta = jtta.DD3DWithTTA(cfg, jm, variables)
        return tta, tta.infer_batch(images, ks)


@pytest.fixture(scope="module")
def bf16_pair(models):
    jm, variables, pm = models
    images, ks = frames()
    _, want = run_jax(tta_cfg(), jm, variables, images, ks)
    tta = ptta.DD3DWithTTA(tta_cfg(), pm)
    return tta, tta.infer_batch(images, ks), want


@pytest.mark.parametrize("max_size", [100000, 300, 200])
@pytest.mark.parametrize("flip", [True, False])
def test_variants_and_buckets_match_jax(max_size, flip):
    sizes = [(375, 1242), (370, 1224), (90, 250), (1242, 375), (100, 100), (33, 257)]
    cfg = tta_cfg()
    cfg.TEST.AUG.MAX_SIZE = max_size
    cfg.TEST.AUG.FLIP = flip
    cfg.TEST.AUG.MIN_SIZES = [320, 384, 448, 512, 576, 96]
    j = jtta.DD3DWithTTA(cfg, None, None)
    p = ptta.DD3DWithTTA(cfg, build_small_port_model())
    for h, w in sizes:
        assert list(p._variants_hw(h, w)) == list(j._variants_hw(h, w)), (h, w)
    want = {}
    for i, (h, w) in enumerate(sizes):  # the JAX package's bucketing (tta.py:141-147)
        for nh, nw, f in j._variants_hw(h, w):
            key = (int(np.ceil(nh / 128) * 128), int(np.ceil(nw / 128) * 128))
            want.setdefault(key, []).append((i, h, w, nh, nw, f))
    got = p.bucket_layout(sizes)
    assert list(got.items()) == list(want.items())


def test_kitti_experiment_buckets():
    """dd3d_kitti_dla34's own TEST.AUG on a KITTI frame: five canvas buckets
    from 384x1152 to 640x1920, one scale and its flip in each."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    assert cfg.TEST.AUG.ENABLED and cfg.TEST.IMS_PER_BATCH == 80
    layout = ptta.DD3DWithTTA(cfg, build_small_port_model()).bucket_layout([(375, 1242)] * 80)
    assert list(layout) == [(384, 1152), (384, 1280), (512, 1536), (512, 1792), (640, 1920)]
    assert all(len(v) == 160 for v in layout.values())


_PORT_MODEL = []


def build_small_port_model():
    """A port model for the tests that only need the wrapper's geometry."""
    if not _PORT_MODEL:
        from dd3d_tpu_torch.models import build_model

        _PORT_MODEL.append(build_model(tta_cfg()))
    return _PORT_MODEL[0]


def test_flip_and_merge_nms_match_jax_exactly():
    """Seeded arrays with ties in the scores and duplicate boxes: the unflip
    and the class-aware merge NMS are JAX's, index for index."""
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 120, 600):
        quat, tvec = rng.randn(n, 4), rng.randn(n, 3)
        for a, b in zip(ptta._flip_boxes3d_np(quat, tvec), jtta._flip_boxes3d_np(quat, tvec)):
            np.testing.assert_array_equal(a, b)
        xy = rng.uniform(0, 300, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (n, 2))], axis=1).astype(np.float32)
        boxes[1::5] = boxes[::5][: len(boxes[1::5])]  # duplicates
        scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # many ties
        classes = rng.randint(0, 3, n)
        for thr in (0.0, 0.5, 0.75):
            np.testing.assert_array_equal(ptta._np_greedy_nms_classaware(boxes, scores, classes, thr),
                                          jtta._np_greedy_nms_classaware(boxes, scores, classes, thr))


def test_bf16_tta_matches_jax(bf16_pair):
    tta, got, want = bf16_pair
    assert dict(tta.stats["buckets"]) == {(128, 384): 8, (128, 256): 6, (128, 512): 2}
    assert len(got) == len(want) == len(SIZES)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(w["classes"]) == 20  # POST_NMS_TOPK survive the merge
        np.testing.assert_array_equal(g["classes"], w["classes"], err_msg=f"image {i}")
        for k in FIELDS:
            np.testing.assert_allclose(g[k], w[k], atol=1e-3, rtol=1e-4, err_msg=f"image {i} {k}")


def recording(fn, events, what):
    """`fn` that first appends (what, canvas (h, w), batch) to `events`."""
    def call(images, *args):
        events.append((what, tuple(images.shape[1:3]), images.shape[0]))
        return fn(images, *args)
    return call


def test_int8_tta_calibrates_the_same_buckets(models, monkeypatch):
    """The four frames in static int8: the port calibrates each of the three
    buckets once, on its whole first batch, just before that bucket's first
    forward, as the JAX package does (its calibration and forwards stubbed
    to record their canvases, since its int8 convs take minutes on the
    CPU); no static scale misses."""
    import dd3d_tpu.models.calibrate as jcal
    import dd3d_tpu_torch.models.calibrate as pcal

    jm, variables, pm = models
    images, ks = frames()
    port_events = []
    real_capture = pcal.capture_scales

    def port_capture(cfg, model, batches, **kwargs):
        port_events.append(("calibrate", tuple(batches[0].shape[1:3]), len(batches[0])))
        return real_capture(cfg, model, batches, **kwargs)

    monkeypatch.setattr(pcal, "capture_scales", port_capture)
    tta = ptta.DD3DWithTTA(tta_cfg(int8=True), pm)
    infer = tta._infer
    tta._infer = recording(infer, port_events, "forward")
    tta._infer.quant = infer.quant
    tta.infer_batch(images, ks)
    assert tta.stats["calibrated"] == [(128, 384), (128, 256), (128, 512)]
    assert tta.quant.misses == []

    jax_events = []
    monkeypatch.setattr(jcal, "capture_scales", lambda cfg, model, variables, batches: (
        jax_events.append(("calibrate", tuple(batches[0].shape[1:3]), batches[0].shape[0])), {})[1])
    with jax_quant_globals_restored():
        jt = jtta.DD3DWithTTA(tta_cfg(int8=True), jm, variables)

        def no_detections(variables, canvas, intrinsics):
            b = canvas.shape[0]
            jax_events.append(("forward", tuple(canvas.shape[1:3]), b))
            z = lambda *shape: np.zeros((b, 20, *shape), np.float32)  # noqa: E731
            return {"boxes2d": z(4), "scores": z(), "classes": z().astype(np.int32), "fpn_levels": z().astype(np.int32),
                    "valid": z().astype(bool), "scores_3d": z(), "boxes3d_quat": z(4), "boxes3d_proj_ctr": z(2),
                    "boxes3d_depth": z(1), "boxes3d_size": z(3), "conf3d": z()}

        jt._infer = no_detections
        jt.infer_batch(images, ks)
    assert sorted(jt._calibrated_buckets) == sorted(tta.stats["calibrated"])
    # JAX pads a forward's batch of 6 to its 8 CPU devices
    assert [(w, hw) for w, hw, _ in jax_events] == [(w, hw) for w, hw, _ in port_events] == [
        ("calibrate", (128, 384)), ("forward", (128, 384)), ("calibrate", (128, 256)), ("forward", (128, 256)),
        ("calibrate", (128, 512)), ("forward", (128, 512))]
    assert [n for w, _, n in port_events] == [8, 8, 6, 6, 2, 2]


# A frame pair whose TTA instances share one small canvas bucket, (128, 128):
# the JAX package's int8 convs run slowly on the CPU (~1 min for this bucket).
INT8_SIZES = [(60, 100), (70, 90)]


@pytest.fixture(scope="module")
def int8_pair(models):
    """Static int8 TTA of both packages on INT8_SIZES at min_sizes [64] with
    flip and QUANT_MIN_CH=0 (serving quantizes every conv that calibration
    observes); the port's forwards recorded with their inputs."""
    jm, variables, pm = models
    rng = np.random.RandomState(6)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in INT8_SIZES]
    ks = [KITTI_K * np.array([[w / 1242], [h / 375], [1.0]]) for h, w in INT8_SIZES]
    cfg = tta_cfg(int8=True)
    cfg.TEST.AUG.MIN_SIZES = [64]
    cfg.TPU.QUANT_MIN_CH = 0
    with jax_quant_globals_restored():
        jt = jtta.DD3DWithTTA(cfg, jm, variables)
        want = jt.infer_batch(images, ks)
    tta = ptta.DD3DWithTTA(cfg, pm)
    pinfer, forwards = tta._infer, []

    def port_forward(canvas, intrinsics):
        out = pinfer(canvas, intrinsics)
        forwards.append((canvas, intrinsics, out))
        return out

    port_forward.quant = pinfer.quant
    tta._infer = port_forward
    got = tta.infer_batch(images, ks)
    with open(jt._scales_path) as f:
        scales_j = json.load(f)
    return cfg, tta, got, sorted(jt._calibrated_buckets), scales_j, want, forwards


def test_int8_tta_scales_match_jax(int8_pair):
    _, tta, _, buckets_j, scales_j, _, _ = int8_pair
    assert tta.stats["calibrated"] == buckets_j == [(128, 128)]
    assert tta.quant.misses == []
    sp = tta.scales
    assert set(sp) == set(scales_j) and all(set(sp[k]) == set(scales_j[k]) for k in sp)
    rel = max(abs(sp[k][t] - scales_j[k][t]) / scales_j[k][t] for k in sp for t in sp[k])
    assert rel < 5e-2, rel


def test_int8_tta_detections(int8_pair, models):
    """As tests/test_torch_int8.py holds static int8: scales captured on a
    batch reproduce the dynamic int8 result on that batch bit for bit. The
    bucket's forward (static scales, calibrated on this very batch) equals
    the dynamic int8 forward of the same canvas exactly, field for field.
    Against JAX the merge keeps as many detections per image, and their
    sorted scores_3d agree within 2e-2, the bound
    tests/test_torch_calibrate.py puts on the sorted scores of static int8
    (its docstring gives the source: XLA's 1-ulp dequant, compounded). The
    merge selects by scores_3d, so its k-th largest moves no more than any
    one candidate's. The detections are not held one by one, nor their
    classes or 2D scores: the top 20 of a variant without NMS come from a
    dense pool of scores, and those moves reorder them and change which
    candidates make the tail (here a class-1 candidate enters the port's
    20 of one image in place of a class-3 one)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    cfg, tta, got, _, _, want, forwards = int8_pair
    _, _, pm = models
    (canvas, intrinsics, static), = forwards
    assert canvas.shape == (4, 128, 128, 3)
    dynamic_cfg = cfg.clone()
    dynamic_cfg.DD3D.INFERENCE.DO_NMS = False
    dynamic = get_inference_fn(pm, dynamic_cfg)(canvas, intrinsics)
    assert not get_inference_fn(pm, dynamic_cfg).quant.scales  # no scales file: dynamic scales
    assert static.keys() == dynamic.keys() and int(static["valid"].sum()) == 4 * 20
    for k in static:
        assert torch.equal(static[k], dynamic[k]), k
    assert [len(g["scores_3d"]) for g in got] == [len(w["scores_3d"]) for w in want] == [20, 20]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.sort(g["scores_3d"]), np.sort(w["scores_3d"]), atol=2e-2, err_msg=f"image {i}")


def test_quant_scales_path_seeds_the_merge_as_jax(tmp_path, monkeypatch, models):
    """The calibration stubbed to a fixed capture in both packages: a seed
    file's entries are kept, and each captured (path, tag) takes the max of
    the seed and the capture."""
    import dd3d_tpu.models.calibrate as jcal
    import dd3d_tpu_torch.models.calibrate as pcal

    _, variables, pm = models
    seed = {"a/conv": {"8x8x16": 2.0, "4x4x16": 1.0}, "b/conv": {"8x8x32": 0.5}}
    path = tmp_path / "seed.json"
    path.write_text(json.dumps(seed))
    captured = {"a/conv": {"8x8x16": 1.5, "2x2x16": 3.0}, "b/conv": {"8x8x32": 0.75}, "c/conv": {"1x1x8": 4.0}}
    monkeypatch.setattr(jcal, "capture_scales", lambda *a, **k: captured)
    monkeypatch.setattr(pcal, "capture_scales", lambda *a, **k: captured)
    cfg = tta_cfg(int8=True)
    cfg.TPU.QUANT_SCALES_PATH = str(path)
    with jax_quant_globals_restored():
        jt = jtta.DD3DWithTTA(cfg, None, variables)
        jt._calibrate_bucket(np.zeros((1, 128, 128, 3), np.float32))
    with open(jt._scales_path) as f:
        want = json.load(f)
    pt = ptta.DD3DWithTTA(cfg, pm)
    pt._calibrate_bucket(np.zeros((1, 128, 128, 3), np.uint8))
    assert pt.scales == want == {"a/conv": {"8x8x16": 2.0, "4x4x16": 1.0, "2x2x16": 3.0},
                                 "b/conv": {"8x8x32": 0.75}, "c/conv": {"1x1x8": 4.0}}
    assert pt.quant.scales is pt.scales  # what the forwards read


def test_unported_tta_options_raise(models):
    """With DD3D.INFERENCE.DO_BEV_NMS the merge of each image ends in the rotated
    BEV NMS, and keeps what JAX's `_merge_one` keeps from the same merged
    union (attributes and speeds riding along); NuscenesDD3DWithTTA's sample
    aggregation equals JAX's on the same merged detections."""
    from dd3d_tpu.structures.pose import Pose as JaxPose
    from dd3d_tpu_torch.models.cross_camera import get_group_idxs
    from dd3d_tpu_torch.structures.pose import Pose

    _, _, pm = models
    cfg = tta_cfg()
    cfg.DD3D.INFERENCE.DO_BEV_NMS = True
    port = ptta.DD3DWithTTA(cfg, pm)
    jax_side = object.__new__(jtta.DD3DWithTTA)  # _merge_one reads these four settings only
    jax_side.nms_thresh, jax_side.post_nms_topk = port.nms_thresh, port.post_nms_topk
    jax_side.do_bev_nms, jax_side.bev_nms_iou_thresh = True, port.bev_nms_iou_thresh
    rng = np.random.RandomState(7)
    merged_out = []
    for image in range(6):
        n = 60
        quat = rng.normal(0, 0.05, (n, 4)) + [np.sqrt(0.5), np.sqrt(0.5), 0, 0]
        centers = rng.uniform([-6, 0, 10], [6, 2, 40], (6, 3))[rng.randint(0, 6, n)]
        corner = rng.uniform(0, 300, (n, 2))
        merged = {"classes": rng.randint(0, 3, n), "scores": rng.rand(n), "scores_3d": rng.rand(n),
                  "boxes2d": np.concatenate([corner, corner + rng.uniform(20, 80, (n, 2))], 1),
                  "quat": quat / np.linalg.norm(quat, axis=1, keepdims=True),
                  "tvec": centers + rng.normal(0, 0.3, (n, 3)), "size": rng.uniform([1.5, 3.5, 1.4], [2, 5, 1.8], (n, 3)),
                  "conf3d": rng.rand(n), "attributes": rng.randint(0, 4, n), "speeds": rng.rand(n)}
        got = port._merge_one({k: [v[: n // 2], v[n // 2:]] for k, v in merged.items()})
        want = jax_side._merge_one({k: [v[: n // 2], v[n // 2:]] for k, v in merged.items()})
        assert set(got) == set(want) and 0 < len(got["classes"]) < n // 2 + 1
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        merged_out.append(dict(got, image_id=f"im{image}", sample_id="s0"))

    cfg = tta_cfg()
    cfg.MODEL.META_ARCHITECTURE = "NuscenesDD3D"
    nusc = ptta.NuscenesDD3DWithTTA(cfg, pm)
    poses = [((np.cos(0.05 * i), 0.0, np.sin(0.05 * i), 0.0), (10.0, -2.0, 1.5)) for i in range(6)]
    groups = get_group_idxs([d["sample_id"] for d in merged_out], 6)
    got = nusc.aggregate_sample(merged_out, groups, 5, [Pose(*p) for p in poses])
    want = jtta.nuscenes_sample_aggregate(merged_out, groups, 5, [JaxPose(*p) for p in poses],
                                          iou_threshold=nusc.bev_nms_iou_thresh, max_num_dets_per_sample=500)
    assert sum(len(g["classes"]) for g in got) < sum(len(m["classes"]) for m in merged_out)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k.endswith("_global"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_int8_conv_launches_split_beyond_2_31():
    """A TTA bucket's stem conv at 160 x 640 x 1920 (16 padded channels,
    3.1e9 elements) exceeds the int8 conv kernel's 32-bit indexing: the
    wrapper launches it on equal runs of images, each within 2^31 elements,
    covering the batch in order."""
    from dd3d_tpu_torch.ops.int8_conv import batch_chunks

    per_image = 640 * 1920 * 16
    runs = batch_chunks(160, per_image)
    assert runs == [(0, 80), (80, 160)]
    assert batch_chunks(8, per_image) == [(0, 8)] and batch_chunks(1, 10, limit=10) == [(0, 1)]
    for b, per, limit in ((160, per_image, 2 ** 31 - 1), (7, 3, 5), (10, 1, 3), (5, 4, 4)):
        runs = batch_chunks(b, per, limit)
        assert [i for r in runs for i in range(*r)] == list(range(b))
        assert all((j - i) * per <= limit for i, j in runs)
        assert len({j - i for i, j in runs[:-1]}) <= 1
    with pytest.raises(ValueError, match="one image"):
        batch_chunks(2, 11, limit=10)
