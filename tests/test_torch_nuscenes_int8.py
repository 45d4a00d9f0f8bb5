"""int8 serving of NuscenesDD3D (dd3d_nusc_dla34 in bench.py's settings:
QUANT_INT8, QUANT_MIN_CH 32, QUANT_UNFOLDED) in the port against the JAX
package, on the CPU in fp32, FPN and heads cut to 64 channels, the same
seeded weights through `convert_flax_variables`, six cameras at 128x192:

- the attribute/speed group alone on the same cls-tower features: one
  int8 conv keyed `attr_logits` (JAX's root path), the ReLU on the speed
  after the split, against JAX's `fused_predictor_apply` (eager) with a
  dynamic and with a static scale, within 2^-22 of each output's largest
  magnitude (tests/test_torch_requant.py's bound);
- the port's static forward, scales captured on the batch at the serving
  gate, equals its dynamic int8 forward bit for bit; the cls tower's last
  link stays unfused (its output has two readers, each quantizing it at its
  own scale), so 55 of the 60 tower links fuse;
- the scales files of both packages' calibrations over the same frames:
  the same keys and tags (`attr_logits` at each level's tag, no `speed`),
  maxima within 5e-2 (tests/test_torch_calibrate.py's bound and source);
- serving with `group_size=6` and the sample aggregation from one shared
  scales file (JAX's), no scale misses: the detections equal to JAX's
  decode and aggregation of the port's int8 head outputs (valid masks,
  classes, levels and attributes exactly, every field within 1e-4, as
  tests/test_torch_nuscenes.py), and against JAX's own int8 serving the
  ten best scores_3d within 2e-2 (tests/test_torch_calibrate.py's bound)
  and the kept counts within 2; the int8 path really ran;
- a batch padded to a multiple of the group with copies of its last image,
  as JAX pads before its sharded forward (dd3d_tpu/models/postprocess.py:
  218-223), gives the unpadded batch's detections exactly: a copy adds no
  new maximum to a dynamic scale;
- NuscenesDD3DWithTTA in static int8 over two frames at min size 64 with
  flip (one canvas bucket): the bucket calibrated on its first batch, the
  scales' keys and tags JAX's and within 5e-2, as many merged detections
  an image, sorted scores_3d within 2e-2, attributes and speeds carried;
  the port's merged detections aggregated as one sample by both packages
  give the same survivors.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dd3d_tpu_torch.ops.int8_conv as int8_ops
from dd3d_tpu.configs import get_experiment_cfg as jax_experiment
from dd3d_tpu.models import layers as jl
from dd3d_tpu.models import tta as jtta
from dd3d_tpu.models.calibrate import prepare_static_scales as jax_prepare_static_scales
from dd3d_tpu.models.layers import load_quant_scales as jax_load_quant_scales
from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import layers as pl
from dd3d_tpu_torch.models import tta as ptta
from dd3d_tpu_torch.models.calibrate import prepare_static_scales
from dd3d_tpu_torch.models.layers import fused_predictor_apply, load_quant_scales
from dd3d_tpu_torch.models.postprocess import get_inference_fn

from tests.test_torch_head_options import seeded_pair
from tests.test_torch_nuscenes import NUSC_K
from tests.torch_port_util import jax_quant_globals_restored, torch_threads

WIDTH = 64
HW = (128, 192)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def int8_cfg(get=get_experiment_cfg):
    """dd3d_nusc_dla34 in bench.py's int8 settings, fp32, FPN 64, every
    candidate kept (an untrained model scores below the default floor)."""
    cfg = get("dd3d_nusc_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.FE.FPN.OUT_CHANNELS = WIDTH
    cfg.DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH = -1.0
    cfg.TPU.QUANT_INT8, cfg.TPU.QUANT_MIN_CH, cfg.TPU.QUANT_UNFOLDED = True, 32, True
    return cfg


def cameras(seed=3):
    """Six uint8 cameras of one sample, their intrinsics and poses."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(6, *HW, 3) * 255).astype(np.uint8)
    images[:, 40:90, 60:140] = 220  # one bright block all cameras share
    pose_quat = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (6, 1))
    pose_tvec = np.tile(np.float32([10.0, -2.0, 1.5]), (6, 1))
    return images, np.stack([NUSC_K] * 6), pose_quat, pose_tvec


@pytest.fixture(scope="module")
def served():
    cfg, cfg_j = int8_cfg(), int8_cfg(jax_experiment)
    jm, variables, pm = seeded_pair(cfg_j, cfg, seed=5)
    images, ks, pq, pt = cameras()
    with jax_quant_globals_restored():
        served_j = jax_prepare_static_scales(cfg_j, jm, variables, [jnp.asarray(images)], tag="nuscint8")
        det_j = jax_get_inference_fn(jm, served_j, group_size=6)(
            variables, jnp.asarray(images), jnp.asarray(ks), jnp.asarray(pq), jnp.asarray(pt))
        det_j = {k: np.asarray(v) for k, v in det_j.items()}
    served_p = prepare_static_scales(cfg, pm, [images], tag="nuscint8")
    return dict(cfg=cfg, jm=jm, variables=variables, pm=pm, inputs=(images, ks, pq, pt), det_j=det_j,
                scales_j=jax_load_quant_scales(served_j.TPU.QUANT_SCALES_PATH),
                scales_p=load_quant_scales(served_p.TPU.QUANT_SCALES_PATH), served_j=served_j)


class JaxAttrSpeed(jl.nn.Module):
    """NuscenesDD3D's two predictors under their root scope names, as JAX's
    module applies them (dd3d_tpu/models/nuscenes_dd3d.py:34-47)."""

    @jl.nn.compact
    def __call__(self, x):
        attr = jl.PredictorConv(4, WIDTH, dtype=jnp.float32, name="attr_logits")
        speed = jl.PredictorConv(1, WIDTH, dtype=jnp.float32, name="speed")
        a, s = jl.fused_predictor_apply(x, [attr, speed], jnp.float32)
        return a, jl.nn.relu(s)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_attr_speed_group_matches_jax_int8(served, static):
    pm = served["pm"]
    x = np.random.RandomState(2).randn(2, 12, 20, WIDTH).astype(np.float32)
    x[x < 0] = 0.0  # a ReLU'd tower output
    params = {"params": {"attr_logits": {"kernel": pm.attr_logits.weight.detach().numpy().transpose(2, 3, 1, 0),
                                         "bias": pm.attr_logits.bias.detach().numpy()},
                         "speed": {"kernel": pm.speed.weight.detach().numpy().transpose(2, 3, 1, 0),
                                   "bias": pm.speed.bias.detach().numpy()}}}
    scales = {"attr_logits": {f"12x20x{WIDTH}": float(np.abs(x).max()) * 0.75}} if static else {}
    with jax_quant_globals_restored():
        jl.QUANT_INT8, jl.QUANT_MIN_CH, jl.QUANT_UNFOLDED, jl.QUANT_SCALES = True, 32, True, scales
        jl.QUANT_OBSERVED_TAGS, jl.QUANT_SCALE_MISSES = {}, []
        attr_j, speed_j = JaxAttrSpeed().apply(params, jnp.asarray(x))
        assert jl.QUANT_SCALE_MISSES == [] and list(jl.QUANT_OBSERVED_TAGS) == ["attr_logits"]
    spec = pl.QuantSpec(enabled=True, min_ch=32, unfolded=True, scales=scales, capture=[])
    calls = []
    real = int8_ops.int8_conv_dequant
    with torch.no_grad(), pl.quant_scope(spec), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "int8_conv_dequant", lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
        attr, speed = fused_predictor_apply(torch.from_numpy(x).permute(0, 3, 1, 2), [pm.attr_logits, pm.speed])
    assert calls == [(5, WIDTH, 3, 3)] and spec.misses == []  # one int8 conv for the group
    assert [(p, t) for p, t, _ in spec.capture] == [("attr_logits", f"12x20x{WIDTH}")]
    for got, want in ((attr, attr_j), (torch.relu(speed), speed_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=2.0 ** -22 * float(np.abs(want).max()))


def test_static_forward_equals_dynamic_and_cls_tower_last_link_stays_unfused(served):
    pm, cfg = served["pm"], served["cfg"]
    images = torch.from_numpy(served["inputs"][0])
    dyn_spec = pl.QuantSpec(enabled=True, min_ch=32, unfolded=True, capture=[])
    with torch.no_grad(), pl.quant_scope(dyn_spec):
        dynamic = pm(images)
    scales = {}
    for path, tag, amax in dyn_spec.capture:
        scales.setdefault(path, {})[tag] = max(float(amax), scales.get(path, {}).get(tag, 0.0))
    links = []
    real = int8_ops.int8_conv

    def counted(*args, **kwargs):
        if kwargs.get("requant") is not None:
            links.append(args[0].shape)
        return real(*args, **kwargs)

    with torch.no_grad(), pl.quant_scope(pl.QuantSpec(enabled=True, min_ch=32, unfolded=True, scales=scales)) as spec, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_ops, "int8_conv", counted)
        static = pm(images)
    assert spec.misses == []
    assert len(links) == (3 + 4 + 4) * 5  # the cls tower's last link (one a level) is not fused
    for key in dynamic:
        for lvl, (a, b) in enumerate(zip(dynamic[key], static[key])):
            assert torch.equal(a, b), f"{key}[{lvl}]"
    assert "attr_logits" in scales and "speed" not in scales
    assert cfg.TPU.QUANT_INT8


def test_scales_files_match_jax(served):
    sj, sp = served["scales_j"], served["scales_p"]
    assert set(sp) == set(sj) and all(set(sp[k]) == set(sj[k]) for k in sj)
    assert "attr_logits" in sp and "speed" not in sp
    assert sp["attr_logits"].keys() == sp["base/fcos2d_head/cls_logits"].keys()
    assert len(sp["attr_logits"]) == 5
    assert "base/backbone/bottom_up/base_layer/conv" in sp
    rel = max(abs(sp[k][t] - sj[k][t]) / sj[k][t] for k in sj for t in sj[k])
    assert rel < 5e-2, rel


class _OutputsAsVariables:
    """A stand-in for JAX's model whose `apply` returns the `variables` it is
    given: JAX's serving function, handed head outputs in their place,
    decodes and aggregates them."""

    def __init__(self, strides):
        self.strides = strides

    def apply(self, variables, images, train=False):
        return variables


def test_int8_serving_with_aggregation_matches_jax(served):
    """The port's int8 serving (one shared scales file, JAX's) against JAX's
    decode, per-image BEV NMS and sample aggregation of the port's own int8
    head outputs: the same detections, with their attributes and speeds
    (the forward is held to JAX's per layer above: its int8 codes move with
    XLA's 1-ulp dequant, which moves a suppression here and there). Against
    JAX's own int8 serving: the ten best scores_3d of the sample within
    2e-2 and the kept counts within 2 (those moves)."""
    pm, det_j = served["pm"], served["det_j"]
    images, ks, pq, pt = served["inputs"]
    infer = get_inference_fn(pm, served["served_j"], group_size=6)
    det_p = {k: v.numpy() for k, v in infer(images, ks, pq, pt).items()}
    assert infer.quant.misses == []
    with torch.no_grad(), pl.quant_scope(infer.quant):
        outputs = {k: [jnp.asarray(x.numpy()) for x in v] for k, v in pm(torch.from_numpy(images)).items()}
    cfg_j = served["served_j"].clone()
    cfg_j.TPU.QUANT_INT8 = False
    det_f = jax_get_inference_fn(_OutputsAsVariables(pm.strides), cfg_j, group_size=6)(
        outputs, jnp.asarray(images), jnp.asarray(ks), jnp.asarray(pq), jnp.asarray(pt))
    det_f = {k: np.asarray(v) for k, v in det_f.items()}
    assert set(det_p) == set(det_f) == set(det_j)
    assert {"attributes", "speeds", "quat_global", "tvec_global"} <= set(det_p)
    valid = det_f["valid"]
    assert valid.sum() > 10
    np.testing.assert_array_equal(det_p["valid"], valid)
    for key in ("classes", "fpn_levels", "attributes"):
        np.testing.assert_array_equal(det_p[key][valid], det_f[key][valid], err_msg=key)
    for key in det_f:
        np.testing.assert_allclose(det_p[key][valid], det_f[key][valid], rtol=1e-4, atol=1e-4, err_msg=key)
    assert (det_p["speeds"][valid] >= 0).all()
    assert abs(int(det_p["valid"].sum()) - int(det_j["valid"].sum())) <= 2
    top_p, top_j = (np.sort(d["scores_3d"][d["valid"]])[::-1][:10] for d in (det_p, det_j))
    np.testing.assert_allclose(top_p, top_j, atol=2e-2)
    fp32 = served["cfg"].clone()
    fp32.TPU.QUANT_INT8 = False
    plain = get_inference_fn(pm, fp32, group_size=6)(images, ks, pq, pt)
    assert not np.array_equal(plain["scores"].numpy(), det_p["scores"])


def test_a_padded_batch_gives_the_same_detections(served):
    pm, cfg = served["pm"], served["cfg"].clone()
    cfg.DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE = False  # per image, so the first rows compare
    images, ks, _, _ = served["inputs"]
    infer = get_inference_fn(pm, cfg)  # dynamic scales
    det = infer(images[:2], ks[:2])
    padded = infer(np.concatenate([images[:2], images[1:2]]), np.concatenate([ks[:2], ks[1:2]]))
    for k in det:
        assert torch.equal(det[k], padded[k][:2]), k


TTA_SIZES = [(60, 100), (70, 90)]


@pytest.fixture(scope="module")
def tta_pair(served):
    """Static int8 TTA of both packages over two frames at min size 64 with
    flip: one (128, 128) canvas bucket of four instances."""
    cfg_p, cfg_j = int8_cfg(), int8_cfg(jax_experiment)
    for cfg in (cfg_p, cfg_j):
        cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.FLIP = [64], True
        cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    rng = np.random.RandomState(6)
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in TTA_SIZES]
    ks = [NUSC_K.astype(np.float64) * np.array([[w / 192], [h / 128], [1.0]]) for h, w in TTA_SIZES]
    with jax_quant_globals_restored():
        jt = jtta.NuscenesDD3DWithTTA(cfg_j, served["jm"], served["variables"])
        want = jt.infer_batch(images, ks)
    tta = ptta.NuscenesDD3DWithTTA(cfg_p, served["pm"])
    got = tta.infer_batch(images, ks)
    with open(jt._scales_path) as f:
        scales_j = json.load(f)
    return dict(jt=jt, tta=tta, got=got, want=want, scales_j=scales_j, buckets_j=sorted(jt._calibrated_buckets))


def test_int8_nuscenes_tta_calibrates_and_merges_as_jax(tta_pair):
    tta, got, want, sj = tta_pair["tta"], tta_pair["got"], tta_pair["want"], tta_pair["scales_j"]
    assert tta.stats["calibrated"] == tta_pair["buckets_j"] == [(128, 128)]
    assert tta.stats["buckets"] == {(128, 128): 4} and tta.quant.misses == []
    sp = tta.scales
    assert set(sp) == set(sj) and all(set(sp[k]) == set(sj[k]) for k in sp) and "attr_logits" in sp
    rel = max(abs(sp[k][t] - sj[k][t]) / sj[k][t] for k in sp for t in sp[k])
    assert rel < 5e-2, rel
    assert [len(g["scores_3d"]) for g in got] == [len(w["scores_3d"]) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["attributes"]) == len(g["speeds"]) == len(g["scores_3d"]) > 0
        np.testing.assert_allclose(np.sort(g["scores_3d"]), np.sort(w["scores_3d"]), atol=2e-2, err_msg=f"image {i}")


def test_int8_nuscenes_tta_sample_aggregation(tta_pair):
    """The port's merged detections of the two frames aggregated as one
    sample (two of its cameras, the same pose) by both packages: the same
    survivors; and as many in all as JAX's aggregation of its own merged
    detections keeps (which of two overlapping boxes survives may move
    with the int8 drift, so not image by image)."""
    from dd3d_tpu.structures.pose import Pose as JaxPose
    from dd3d_tpu_torch.structures.pose import Pose

    got, want = tta_pair["got"], tta_pair["want"]
    pose = dict(wxyz=np.array([1.0, 0.0, 0.0, 0.0]), tvec=np.array([10.0, -2.0, 1.5]))
    agg_p = tta_pair["tta"].aggregate_sample(got, {"s": [0, 1]}, 10, [Pose(**pose)] * 2)
    agg_j = tta_pair["jt"].aggregate_sample([dict(g) for g in got], {"s": [0, 1]}, 10, [JaxPose(**pose)] * 2)
    for a, b in zip(agg_p, agg_j):
        assert set(a) == set(b) and len(a["scores_3d"]) == len(b["scores_3d"])
        for key in ("classes", "attributes"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        for key in ("scores_3d", "speeds", "quat_global", "tvec_global"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-5, err_msg=key)
    own_j = tta_pair["jt"].aggregate_sample(want, {"s": [0, 1]}, 10, [JaxPose(**pose)] * 2)
    assert sum(len(a["scores_3d"]) for a in agg_p) == sum(len(a["scores_3d"]) for a in own_j) > 0
