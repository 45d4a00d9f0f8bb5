"""dd3d_kitti_v99 (VoVNet + FPN P3-P6 + FCOS2D/FCOS3D at four levels) in the
port against the JAX package, on the CPU in fp32 with FE.BACKBONE.NAME =
V-19-slim-eSE (the V-99-eSE preset differs in block counts only and is held
in name and shape by tests/test_torch_vovnet.py):

- all 8 head outputs at all 4 levels of the model's forward at 128x192,
  batch 2, within atol = rtol = 1e-4 (as tests/test_torch_model.py), and the
  detections of `get_inference_fn` against JAX's: equal valid rows, classes
  and levels, every field within 1e-4;
- one train step at four levels (FPN 64, 1-conv towers, 128x128, batch 2)
  against JAX's `make_train_step`: the losses, and every gradient and update
  per tensor within 5e-3 of the port's own f64 step, JAX's and the port's as
  flat vectors within 1e-3 in L2 (the bounds of tests/test_torch_train.py);
  the weight-decay mask equal to JAX's at the VoVNet parameters;
- static int8 in scripts/bench_v99.py's settings (QUANT_INT8, QUANT_MIN_CH
  32): the calibrated scale keys and tags equal to JAX's
  `prepare_static_scales`, maxima within 5e-2, sorted detection scores within
  2e-2 (the bounds of tests/test_torch_calibrate.py);
- `predict` and `calibrate_int8` pad a 375x1200 frame to JAX's 384x1280
  canvas, not to the backbone's stride of 64 (384x1216);
- TPU.PALLAS_STEM_DW routes nothing on this backbone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg as jax_get_experiment_cfg
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models.calibrate import prepare_static_scales as jax_prepare_static_scales
from dd3d_tpu.models.layers import load_quant_scales as jax_load_quant_scales
from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu.training.optim import _wd_mask, build_optimizer as jax_build_optimizer
from dd3d_tpu.training.train_step import TrainState, make_train_step as jax_make_train_step
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.calibrate import prepare_static_scales
from dd3d_tpu_torch.models.dd3d import HEAD_KEYS_2D, HEAD_KEYS_3D
from dd3d_tpu_torch.models.layers import FoldableConv, load_quant_scales
from dd3d_tpu_torch.models.postprocess import get_inference_fn
from dd3d_tpu_torch.training import optim as popt
from dd3d_tpu_torch.training.synthetic import synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_params, convert_flax_variables, flax_param_paths

from tests.test_torch_train import capture_grads, distances_from_oracle, float_means_double
from tests.torch_port_util import both_models, jax_quant_globals_restored, seed_flax_variables, torch_threads, \
    v99_cfg, v99_state_dict

HEAD_KEYS = HEAD_KEYS_2D + HEAD_KEYS_3D
KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


@pytest.fixture(scope="module")
def forward():
    cfg = v99_cfg()
    jm, variables, pm = both_models(cfg, v99_state_dict())
    images = (np.random.RandomState(3).rand(2, 128, 192, 3) * 255).astype(np.uint8)
    out_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out_p = pm(torch.from_numpy(images))
    return dict(cfg=cfg, jm=jm, variables=variables, pm=pm, images=images, out_j=out_j, out_p=out_p)


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_head_output_matches_jax(forward, key):
    out_j, out_p = forward["out_j"], forward["out_p"]
    assert set(out_p) == set(HEAD_KEYS) and len(out_p[key]) == len(out_j[key]) == 4
    for lvl, (p, j) in enumerate(zip(out_p[key], out_j[key])):
        assert p.shape == j.shape == (2, 128 // 8 >> lvl, 192 // 8 >> lvl, p.shape[-1])
        np.testing.assert_allclose(p.numpy(), np.asarray(j, np.float32), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{key} level {lvl}")


def test_strides_and_levels_match_jax(forward):
    pm, jm = forward["pm"], forward["jm"]
    assert pm.strides == tuple(jm.strides) == (8, 16, 32, 64)
    assert pm.backbone.size_divisibility == 64
    assert len(pm.fcos3d_head.scales_depth) == len(pm.fcos3d_head.offsets_depth) == 4
    assert len(pm.fcos2d_head.scales_box2d_reg) == 4 and len(pm.fcos3d_head.mean_depth_per_level) == 5


def test_detections_match_jax(forward):
    cfg, pm, jm, variables, images = (forward[k] for k in ("cfg", "pm", "jm", "variables", "images"))
    intrinsics = np.stack([KITTI_K, KITTI_K * np.array([[1.1], [1.1], [1]], np.float32)])
    det_j = jax_get_inference_fn(jm, cfg)(variables, jnp.asarray(images), jnp.asarray(intrinsics))
    det_j = {k: np.asarray(v) for k, v in det_j.items()}
    det_p = {k: v.numpy() for k, v in get_inference_fn(pm, cfg)(images, intrinsics).items()}
    assert set(det_p) == set(det_j)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.sum() > 20
    for key in ("classes", "fpn_levels"):
        np.testing.assert_array_equal(det_p[key][valid], det_j[key][valid], err_msg=key)
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-4, atol=1e-4, err_msg=key)


# --- the train step at four levels --------------------------------------------

def small_train_cfg():
    """dd3d_kitti_v99 cut to a CPU test: V-19-slim-eSE, FPN 64, 1-conv towers,
    f32, lr 1.0 from step 0; TPU.PALLAS_STEM_DW on, which this trunk ignores."""
    cfg = v99_cfg()
    cfg.TPU.PALLAS_STEM_DW = True
    cfg.FE.FPN.OUT_CHANNELS = 64
    cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = 1.0, 0
    return cfg


def test_pallas_stem_dw_routes_nothing_on_vovnet():
    """Only the DLA trunk reads TPU.PALLAS_STEM_DW (dd3d_tpu/models/dla.py:404)."""
    model = build_model(small_train_cfg())
    assert not any(m.kernel_weight_grad for m in model.modules() if isinstance(m, FoldableConv))


@pytest.fixture(scope="module")
def train_case():
    cfg = small_train_cfg()
    jm = build_jax_model(cfg)
    variables = seed_flax_variables(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False), 1)
    pm = build_model(cfg)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    batch = synthetic_batch(np.random.RandomState(1), 2, 128, 128, max_gt=16, max_gt_per_image=6)

    tx = optax.chain(capture_grads(), jax_build_optimizer(cfg, variables["params"]))
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # compiled for this host, as test_torch_train.py
    try:
        new_state, metrics_j = jax.jit(jax_make_train_step(cfg, jm))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    cfg64 = cfg.clone()
    cfg64.TPU.COMPUTE_DTYPE = "float64"
    m64 = build_model(cfg64).double()
    m64.load_state_dict(before, strict=True)
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in to_device(batch, "cpu").items()}
    ts64 = create_train_state(cfg64, m64, "cpu")
    with float_means_double():
        make_train_step(cfg64, ts64.model, ts64.optimizer)(batch64)
    ts = create_train_state(cfg, pm, "cpu")
    metrics_p = make_train_step(cfg, ts.model, ts.optimizer)(to_device(batch, "cpu"))
    return dict(pm=pm, params=variables["params"], before=before,
                metrics_p={k: float(v) for k, v in metrics_p.items()},
                metrics_j={k: float(v) for k, v in metrics_j.items()},
                grads_j=convert_flax_params(new_state.opt_state[0], pm),
                params_j=convert_flax_params(new_state.params, pm),
                grads64={n: p.grad.numpy() for n, p in m64.named_parameters()},
                updates64={n: p.detach().numpy() - before[n].double().numpy() for n, p in m64.named_parameters()})


def test_train_step_losses_match(train_case):
    mp, mj = train_case["metrics_p"], train_case["metrics_j"]
    assert set(mp) == set(mj) and mp["loss_finite"] == 1.0
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=2e-4, err_msg=k)


PORT_BOUND = 5e-3  # per tensor, relative to its largest f64 magnitude (tests/test_torch_train.py)


def _assert_close(got, jax_side, oracle):
    for name, (err_port, _err_jax) in distances_from_oracle(got, jax_side, oracle).items():
        assert err_port <= PORT_BOUND, f"{name}: port {err_port:.3e} from its f64 step"
    flat_o = np.concatenate([oracle[n].ravel() for n in jax_side])
    flat_g = np.concatenate([got[n].ravel() for n in jax_side])
    flat_j = np.concatenate([w.ravel() for w in jax_side.values()])
    assert np.linalg.norm(flat_j - flat_o) <= 1e-3 * np.linalg.norm(flat_o), "JAX's step is not the oracle's"
    assert np.linalg.norm(flat_g - flat_j) <= 1e-3 * np.linalg.norm(flat_j)


def test_train_step_gradients_match(train_case):
    pm = train_case["pm"]
    _assert_close({n: p.grad.numpy() for n, p in pm.named_parameters()},
                  {n: g.numpy() for n, g in train_case["grads_j"].items()}, train_case["grads64"])


def test_train_step_updates_match(train_case):
    pm, before, params_j = train_case["pm"], train_case["before"], train_case["params_j"]
    names = [n for n, _ in pm.named_parameters()]
    _assert_close({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                  {n: (params_j[n] - before[n]).numpy() for n in names}, train_case["updates64"])


def test_weight_decay_mask_matches_jax(train_case):
    pm, params = train_case["pm"], train_case["params"]
    flat = {"/".join(str(p.key) for p in k): bool(v)
            for k, v in jax.tree_util.tree_leaves_with_path(_wd_mask(params, True))}
    paths = flax_param_paths(pm)
    mask = popt.weight_decay_mask(pm, True)
    assert {"/".join(p) for p in paths.values()} == set(flat)
    assert {n for n, m in mask.items() if not m} == {n for n, p in paths.items() if not flat["/".join(p)]}
    assert any(n.startswith("backbone.bottom_up.OSA") and n.endswith("ese.fc.weight") for n in mask if mask[n])
    assert len([n for n, m in mask.items() if not m]) == 2 * 4 * 2  # the FCOS2D towers' per-level BN affines


# --- static int8 in scripts/bench_v99.py's settings -----------------------------

@pytest.fixture(scope="module")
def calibrated(forward):
    cfg = v99_cfg()
    cfg.TPU.QUANT_INT8, cfg.TPU.QUANT_MIN_CH = True, 32
    cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK = 20
    jm, variables, pm, images = forward["jm"], forward["variables"], forward["pm"], forward["images"]
    intrinsics = np.stack([KITTI_K, KITTI_K])
    with jax_quant_globals_restored():
        cfg_j = jax_prepare_static_scales(cfg, jm, variables, [jnp.asarray(images)], tag="v99test")
        det_j = jax_get_inference_fn(jm, cfg_j)(variables, jnp.asarray(images), jnp.asarray(intrinsics))
        det_j = {k: np.asarray(v) for k, v in det_j.items()}
    cfg_p = prepare_static_scales(cfg, pm, [images], tag="v99test")
    infer = get_inference_fn(pm, cfg_p)
    det_p = {k: v.numpy() for k, v in infer(images, intrinsics).items()}
    return dict(scales_j=jax_load_quant_scales(cfg_j.TPU.QUANT_SCALES_PATH),
                scales_p=load_quant_scales(cfg_p.TPU.QUANT_SCALES_PATH), det_j=det_j, det_p=det_p,
                misses=infer.quant.misses, pm=pm, images=images, intrinsics=intrinsics)


def test_int8_scale_keys_match_jax(calibrated):
    sj, sp = calibrated["scales_j"], calibrated["scales_p"]
    assert set(sp) == set(sj) and all(set(sp[k]) == set(sj[k]) for k in sj)
    assert not any(k.endswith(("ese/fc", "/dw")) or "top_p6" in k for k in sp)  # flax nn.Convs never quantize
    assert "backbone/bottom_up/stem1/conv" in sp and "backbone/bottom_up/OSA5_1/concat/conv" in sp
    for t in sj["backbone/bottom_up/stem1/conv"]:  # no int8 code upstream can differ yet
        assert sp["backbone/bottom_up/stem1/conv"][t] == pytest.approx(sj["backbone/bottom_up/stem1/conv"][t],
                                                                       rel=1e-6)
    rel = max(abs(sp[k][t] - sj[k][t]) / sj[k][t] for k in sj for t in sj[k])
    assert rel < 5e-2, rel


def test_int8_detections_match_jax(calibrated):
    det_j, det_p = calibrated["det_j"], calibrated["det_p"]
    assert calibrated["misses"] == []
    np.testing.assert_array_equal(det_p["valid"], det_j["valid"])
    assert det_j["valid"].sum() == 40
    for key in ("scores", "scores_3d"):
        for i in range(2):
            a = np.sort(det_j[key][i][det_j["valid"][i]])
            b = np.sort(det_p[key][i][det_p["valid"][i]])
            np.testing.assert_allclose(b, a, atol=2e-2, err_msg=f"{key} image {i}")
    fp32 = get_inference_fn(calibrated["pm"], v99_cfg())(calibrated["images"], calibrated["intrinsics"])
    assert not np.array_equal(fp32["scores"].numpy()[:, :20], det_p["scores"][:, :20])  # int8 really ran


# --- the canvas of predict and calibrate_int8 ----------------------------------

def test_predict_pads_like_jax(tmp_path, monkeypatch):
    """Under dd3d_kitti_v99 a 375x1200 frame gives a 384x1280 canvas and the
    batch of JAX's mapper and collate (scripts/predict.py:157), byte for
    byte."""
    import cv2

    from dd3d_tpu.data import native
    from dd3d_tpu.data.augmentations import build_augmentation
    from dd3d_tpu.data.mapper import DatasetMapper, collate_batch
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.predict import iter_batches, read_image_dicts

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    files = [str(tmp_path / "000000.png")]
    cv2.imwrite(files[0], np.random.RandomState(5).randint(0, 256, (375, 1200, 3), dtype=np.uint8))
    cfg = get_experiment_cfg("dd3d_kitti_v99")
    assert build_model(cfg).backbone.size_divisibility == 64
    dicts = read_image_dicts(files, KITTI_K.astype(np.float64))
    (_, batch, meta), = iter_batches(cfg, dicts, 1)
    assert batch["image"].shape == (1, 384, 1280, 3) and batch["image_size"].tolist() == [[384, 1229]]
    jcfg = jax_get_experiment_cfg("dd3d_kitti_v99")
    mapper = DatasetMapper(build_augmentation(jcfg, is_train=False), is_train=False, box3d_on=True)
    want, want_meta = collate_batch([mapper(d, np.random.RandomState(0)) for d in dicts], max_gt=1,
                                    size_divisibility=128)
    assert list(batch) == list(want) and meta == want_meta
    for k, v in want.items():
        assert batch[k].dtype == v.dtype and batch[k].tobytes() == v.tobytes(), k
