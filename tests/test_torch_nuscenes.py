"""NuscenesDD3D (dd3d_nusc_dla34) in the port against the JAX package, on the
CPU in fp32, with the same reference-named weights (`nusc_state_dict`):

- the forward of 6 cameras at 128x192: all ten head outputs (attr_logits
  and speed included) at all five levels within atol = rtol = 1e-4;
- the serving function at group size 6 (per-image DO_BEV_NMS, then the
  sample aggregation with each camera's pose) against JAX's
  `get_inference_fn(group_size=6)`: equal valid masks, classes, levels and
  attributes, every other field (global boxes included) within 1e-4; the
  aggregation cuts the sample; without poses it does not run;
- `nuscenes_dd3d_losses` against JAX's on seeded head outputs, with
  ignored attributes, NaN speeds and an image without GT: every loss within
  rtol 1e-5;
- one train step (FPN 64, 1-conv towers, 256x256, batch 2, ignored
  attributes and NaN speeds among the GT; He-initialized convs and seeded
  norm statistics as tests/test_torch_train.py), once with the trunk and
  FPN on FrozenBN and once at the experiment's norms (live BN in the trunk,
  the FPN and the towers), against JAX's `make_train_step`: the losses
  within 2e-4; every gradient and update per tensor within 5e-3 of the
  port's own f64 step replayed on the f32 step's ReLU branches, and all of
  them as one vector within 2e-4 of it in L2; JAX and the port against the
  plain f64 step and each other in flat L2 (see the bounds' comment);
- the build: `dd3d_nusc_v99` builds and serves, a reference-named `.pth`
  of NuscenesDD3D loads (`reference_to_port_names` nests DD3D under
  `base`), the int8 scale keys are JAX's scope paths, and TPU.QUANT_INT8
  raises.
"""
import contextlib
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

# imported before any trace: the JAX step imports it inside its traced
# function, where the module's constant would be made as a tracer that a
# second trace (the next parameter of `train_case`) then finds leaked
import dd3d_tpu.ops.color_jitter  # noqa: F401
from dd3d_tpu.configs import get_experiment_cfg as jax_get_experiment_cfg
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.models.nuscenes_dd3d import nuscenes_dd3d_losses as jax_nuscenes_losses
from dd3d_tpu.models.postprocess import get_inference_fn as jax_get_inference_fn
from dd3d_tpu.training.optim import build_optimizer as jax_build_optimizer
from dd3d_tpu.training.train_step import TrainState, make_train_step as jax_make_train_step
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.dd3d import HEAD_KEYS_2D, HEAD_KEYS_3D
from dd3d_tpu_torch.models.nuscenes_dd3d import NuscenesDD3D, nuscenes_dd3d_losses
from dd3d_tpu_torch.models.postprocess import get_inference_fn
from dd3d_tpu_torch.training.synthetic import synthetic_batch
from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.convert_checkpoint import (
    convert_flax_params,
    convert_flax_variables,
    reference_to_port_names,
)

from tests.test_torch_train import capture_grads, distances_from_oracle, float_means_double, seeded_model
from tests.torch_port_util import both_models, jax_variables, nusc_state_dict, torch_threads

HEAD_KEYS = HEAD_KEYS_2D + HEAD_KEYS_3D + ("attr_logits", "speed")
NUSC_K = np.float32([[160.0, 0.0, 96.0], [0.0, 160.0, 64.0], [0.0, 0.0, 1.0]])
STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(4):
        yield


def nusc_cfgs():
    """(port cfg, JAX cfg) of dd3d_nusc_dla34 in fp32, every candidate kept
    (an untrained model scores below the default floor)."""
    out = []
    for get in (get_experiment_cfg, jax_get_experiment_cfg):
        cfg = get("dd3d_nusc_dla34")
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH = -1.0
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def served():
    cfg, jcfg = nusc_cfgs()
    jm, variables, pm = both_models(jcfg, nusc_state_dict())
    rng = np.random.RandomState(3)
    images = (rng.rand(6, 128, 192, 3) * 255).astype(np.uint8)
    images[:, 40:90, 60:140] = 220  # one bright block all cameras share
    intrinsics = np.stack([NUSC_K] * 6)
    pose_quat = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (6, 1))
    pose_tvec = np.tile(np.float32([10.0, -2.0, 1.5]), (6, 1))
    out_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out_p = pm(torch.from_numpy(images))
    det_j = jax_get_inference_fn(jm, jcfg, group_size=6)(
        variables, jnp.asarray(images), jnp.asarray(intrinsics), jnp.asarray(pose_quat), jnp.asarray(pose_tvec))
    infer = get_inference_fn(pm, cfg, group_size=6)
    det_p = infer(images, intrinsics, pose_quat, pose_tvec)
    det_plain = get_inference_fn(pm, cfg)(images, intrinsics)
    return dict(pm=pm, out_j=out_j, out_p=out_p, det_j={k: np.asarray(v) for k, v in det_j.items()},
                det_p={k: v.numpy() for k, v in det_p.items()}, det_plain={k: v.numpy() for k, v in det_plain.items()},
                infer=infer, images=images, intrinsics=intrinsics)


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_head_output_matches_jax(served, key):
    out_j, out_p = served["out_j"], served["out_p"]
    assert set(out_p) == set(HEAD_KEYS) and len(out_p[key]) == len(out_j[key]) == 5
    for lvl, (p, j) in enumerate(zip(out_p[key], out_j[key])):
        assert p.shape == j.shape and p.shape[:3] == (6, -(-128 // STRIDES[lvl]), -(-192 // STRIDES[lvl]))
        np.testing.assert_allclose(p.numpy(), np.asarray(j, np.float32), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{key} level {lvl}")


def test_serving_with_sample_aggregation_matches_jax(served):
    det_p, det_j = served["det_p"], served["det_j"]
    assert set(det_p) == set(det_j) and {"attributes", "speeds", "quat_global", "tvec_global"} <= set(det_p)
    valid = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], valid)
    assert valid.sum() > 20
    for key in ("classes", "fpn_levels", "attributes"):
        np.testing.assert_array_equal(det_p[key][valid], det_j[key][valid], err_msg=key)
    for key in det_j:
        np.testing.assert_allclose(det_p[key][valid], det_j[key][valid], rtol=1e-4, atol=1e-4, err_msg=key)


def test_aggregation_cuts_the_sample(served):
    """Six cameras of one image under one pose: every detection appears six
    times in the global frame, so the sample keeps far fewer than the
    images alone (each with its own BEV NMS)."""
    det_p, det_plain = served["det_p"], served["det_plain"]
    assert "quat_global" not in det_plain  # no poses, group size 1: no aggregation
    assert 0 < det_p["valid"].sum() <= det_plain["valid"].sum() // 3
    np.testing.assert_allclose(det_p["tvec_global"][..., 0] - 10.0, 0, atol=1e3)  # finite, offset by the pose


def test_sample_aggregation_needs_poses(served):
    det = served["infer"](served["images"], served["intrinsics"])  # no poses: the per-image detections
    np.testing.assert_array_equal(det["valid"].numpy(), served["det_plain"]["valid"])


def loss_case(seed):
    """Seeded head outputs at 128x128 and a GT batch with ignored
    attributes (id 3), NaN speeds and an image without GT."""
    rng = np.random.RandomState(seed)
    b, widths = 3, {"logits": 10, "box2d_reg": 4, "centerness": 1, "quat": 40, "proj_ctr": 20, "depth": 10,
                    "size": 30, "conf": 10, "attr_logits": 4, "speed": 1}
    outputs = {k: [rng.randn(b, 128 // s, 128 // s, c).astype(np.float32) for s in STRIDES]
               for k, c in widths.items()}
    outputs["box2d_reg"] = [np.abs(x) * 8 for x in outputs["box2d_reg"]]
    outputs["speed"] = [np.maximum(x, 0) for x in outputs["speed"]]
    batch = synthetic_batch(rng, b, 128, 128, max_gt=8, num_classes=10, max_gt_per_image=6)
    batch["gt_valid"][2] = False  # an image without GT
    batch["gt_attributes"] = rng.randint(0, 4, (b, 8)).astype(np.int32)
    speeds = (rng.rand(b, 8) * 10).astype(np.float32)
    speeds[rng.rand(b, 8) < 0.3] = np.nan
    batch["gt_speeds"] = speeds
    return outputs, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_nuscenes_losses_match_jax(seed):
    cfg, jcfg = nusc_cfgs()
    outputs, batch = loss_case(seed)
    assert np.isnan(batch["gt_speeds"]).any() and (batch["gt_attributes"] == 3).any()
    got = nuscenes_dd3d_losses(cfg, {k: [torch.from_numpy(x) for x in v] for k, v in outputs.items()},
                               {k: torch.from_numpy(v) for k, v in batch.items()}, STRIDES)
    want = jax_nuscenes_losses(jcfg, {k: [jnp.asarray(x) for x in v] for k, v in outputs.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()}, strides=STRIDES)
    assert set(got) == set(want) and {"loss_attr", "loss_speed"} <= set(got)
    for k in want:
        assert np.isfinite(float(got[k])) and float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


# --- one train step -----------------------------------------------------------

NORMS = {"frozen-trunk": "FrozenBN", "experiment-norms": None}


def small_train_cfgs(trunk_norm):
    """dd3d_nusc_dla34 cut to a CPU test: FPN 64, 1-conv towers, f32, lr 1.0
    from step 0. `trunk_norm` "FrozenBN" puts the trunk and FPN on FrozenBN,
    as the KITTI test's (tests/test_torch_train.py::small_cfg); None keeps
    the experiment's norms (live BN in the trunk, the FPN and the FCOS2D
    towers). The canvas is 256x256 (P7's tower BN sees 8 values a channel,
    not 2)."""
    out = []
    for get in (get_experiment_cfg, jax_get_experiment_cfg):
        cfg = get("dd3d_nusc_dla34")
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.FE.FPN.OUT_CHANNELS = 64
        if trunk_norm:
            cfg.FE.BACKBONE.NORM = cfg.FE.FPN.NORM = trunk_norm
        cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
        cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = 1.0, 0
        out.append(cfg)
    return out


@contextlib.contextmanager
def relu_branches(masks: List[torch.Tensor], replay: bool, flips: Optional[List[float]] = None):
    """Inside, every F.relu of the port records where it passes its input
    (replay=False), or takes those recorded branches in call order
    (replay=True): x * mask, whose gradient is relu's, grad * mask. A step
    replayed in f64 on the branches of the f32 step differs from it by
    rounding alone. The plain f64 step does not: where a ReLU's input lies
    within f32 rounding of 0, the f32 and f64 steps take different branches
    there, and that one element moves the gradients of every tensor
    upstream of it. On replay, `flips` gets, for each element whose f64
    input lies on the other side of 0, |input| over the largest |input| of
    its call."""
    relu = F.relu
    calls = iter(masks)

    def branched(x, inplace=False):
        if replay:
            mask = next(calls)
            if flips is not None:
                other = (x.detach() > 0) != mask
                if other.any():
                    flips.extend((x.detach()[other].abs() / x.detach().abs().max()).tolist())
            return x * mask.to(x.dtype)
        y = relu(x)
        masks.append(y.detach() > 0)
        return y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "relu", branched)
        yield
    if replay:
        assert next(calls, None) is None, "the replayed step made fewer ReLU calls than the recorded one"


def f64_step(cfg, before, batch):
    """The port's train step in f64 from the same weights: its model (the
    gradients in .grad) and its updates."""
    cfg64 = cfg.clone()
    cfg64.TPU.COMPUTE_DTYPE = "float64"
    m64 = build_model(cfg64).double()
    m64.load_state_dict(before, strict=True)
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in to_device(batch, "cpu").items()}
    ts64 = create_train_state(cfg64, m64, "cpu")
    with float_means_double():
        make_train_step(cfg64, ts64.model, ts64.optimizer)(batch64)
    return ({n: p.grad.numpy() for n, p in m64.named_parameters()},
            {n: p.detach().numpy() - before[n].double().numpy() for n, p in m64.named_parameters()})


@pytest.fixture(scope="module", params=list(NORMS))
def train_case(request):
    return make_train_case(request.param)


def make_train_case(norms: str) -> dict:
    """One train step of the port (f32), of JAX, and of the port in f64,
    plainly and on the f32 step's ReLU branches, from the same weights."""
    cfg, jcfg = small_train_cfgs(NORMS[norms])
    pm = seeded_model(cfg)  # He convs and seeded norm statistics, as tests/test_torch_train.py
    jm = build_jax_model(jcfg)
    reference_names = {k.removeprefix("base."): v.numpy() for k, v in pm.state_dict().items()}
    variables = jax_variables(jcfg, jm, reference_names)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    rng = np.random.RandomState(1)
    batch = synthetic_batch(rng, 2, 256, 256, max_gt=16, num_classes=10, max_gt_per_image=6)
    batch["gt_attributes"] = rng.randint(0, 4, (2, 16)).astype(np.int32)  # 3: ignored
    speeds = (rng.rand(2, 16) * 10).astype(np.float32)
    speeds[rng.rand(2, 16) < 0.3] = np.nan
    batch["gt_speeds"] = speeds

    tx = optax.chain(capture_grads(), jax_build_optimizer(jcfg, variables["params"]))
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # compiled for this host, as test_torch_train.py
    try:
        new_state, metrics_j = jax.jit(jax_make_train_step(jcfg, jm))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    ts = create_train_state(cfg, pm, "cpu")
    masks: List[torch.Tensor] = []
    with relu_branches(masks, replay=False):
        metrics_p = make_train_step(cfg, ts.model, ts.optimizer)(to_device(batch, "cpu"))
    grads64, updates64 = f64_step(cfg, before, batch)
    flips: List[float] = []
    with relu_branches(masks, replay=True, flips=flips):
        grads64_branched, updates64_branched = f64_step(cfg, before, batch)
    return dict(norms=norms, flips=flips, pm=pm, before=before,
                metrics_p={k: float(v) for k, v in metrics_p.items()},
                metrics_j={k: float(v) for k, v in metrics_j.items()},
                grads_j=convert_flax_params(new_state.opt_state[0], pm),
                params_j=convert_flax_params(new_state.params, pm),
                grads64=grads64, updates64=updates64,
                grads64_branched=grads64_branched, updates64_branched=updates64_branched)


def test_train_step_losses_match(train_case):
    mp, mj = train_case["metrics_p"], train_case["metrics_j"]
    assert set(mp) == set(mj) and {"loss_attr", "loss_speed"} <= set(mp) and mp["loss_finite"] == 1.0
    assert mp["loss_attr"] > 0 and mp["loss_speed"] > 0
    for k in mj:
        # the gradient's norm moves with the ReLU flips (see the bounds below)
        rtol = PORT_JAX_FLAT_BOUND[train_case["norms"]] if k == "grad_norm" else 2e-4
        np.testing.assert_allclose(mp[k], mj[k], rtol=rtol, err_msg=k)


# The bounds, measured on the CPU at this input (batch 2, 256x256;
# `python -m tests.test_torch_nuscenes` prints the distances):
# - the f64 step replayed on the f32 step's ReLU branches leaves them at 6
#   elements with the trunk on FrozenBN and 12 at the experiment's norms,
#   each within 1e-4 of 0 relative to its call's largest input (measured
#   3.7e-7 and 4.5e-6): rounding, not a fault. One of them, in P6's
#   cls-tower ReLU, moves P6's tower norm, the P6 conv and DLA level 4 of
#   the port's step by up to 1.6e-2 from the plain f64 step;
# - the port's f32 step against its f64 step replayed on the f32 step's ReLU
#   branches (`relu_branches`), per tensor relative to the tensor's largest
#   f64 magnitude, every tensor: within 5e-3, the bound of
#   tests/test_torch_train.py (measured 9.3e-4 with the trunk on FrozenBN,
#   3.7e-4 at the experiment's norms), and as one flat vector within 2e-4
#   in L2 (measured 5.2e-5 and 4.5e-5). This is the test of the port's step,
#   its live-BN backward included;
# - JAX's f32 step against the plain f64 step as one flat vector in L2, and
#   the port against JAX: each takes its own branches where a ReLU input lies
#   within f32 rounding of 0, so these distances are those flips', not a
#   rounding error. With the trunk on FrozenBN JAX is within 1e-3 of f64
#   (measured 1.4e-5) and the port within 2e-3 of JAX (measured 1.17e-3:
#   the one flipped element of the port's P6 tower ReLU). At the
#   experiment's norms (live BN in a trunk of ~40 ReLU'd layers) the flips
#   are many: JAX lies 1.5e-2 from f64, the port 6.8e-3 and the port 1.4e-2
#   from JAX (per tensor JAX up to 0.24 from f64, the port 6.2e-2), so there
#   both flat distances are held within 5e-2, a bound on gross faults only;
#   the port's step is held by the branch-replayed oracle above.
PORT_BOUND = 5e-3
FLIP_BOUND = 1e-4
PORT_BRANCHED_FLAT_BOUND = 2e-4
JAX_FLAT_BOUND = {"frozen-trunk": 1e-3, "experiment-norms": 5e-2}
PORT_JAX_FLAT_BOUND = {"frozen-trunk": 2e-3, "experiment-norms": 5e-2}


def _assert_close(got, jax_side, oracle, branched, norms):
    for name, (err_port, _err_jax) in distances_from_oracle(got, jax_side, branched).items():
        assert err_port <= PORT_BOUND, f"{name}: port {err_port:.3e} from its branch-replayed f64 step"
    flat = lambda d: np.concatenate([d[n].ravel() for n in jax_side])  # noqa: E731
    flat_o, flat_b, flat_g, flat_j = flat(oracle), flat(branched), flat(got), flat(jax_side)
    assert np.linalg.norm(flat_g - flat_b) <= PORT_BRANCHED_FLAT_BOUND * np.linalg.norm(flat_b)
    assert np.linalg.norm(flat_j - flat_o) <= JAX_FLAT_BOUND[norms] * np.linalg.norm(flat_o), \
        "JAX's step is not the oracle's"
    assert np.linalg.norm(flat_g - flat_j) <= PORT_JAX_FLAT_BOUND[norms] * np.linalg.norm(flat_j)


def test_train_step_gradients_match(train_case):
    pm = train_case["pm"]
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert np.abs(grads["attr_logits.weight"]).max() > 0 and np.abs(grads["speed.weight"]).max() > 0
    # the f64 step leaves the f32 step's branches only within rounding of 0
    assert max(train_case["flips"], default=0.0) <= FLIP_BOUND, sorted(train_case["flips"])[-5:]
    _assert_close(grads, {n: g.numpy() for n, g in train_case["grads_j"].items()}, train_case["grads64"],
                  train_case["grads64_branched"], train_case["norms"])


def test_train_step_updates_match(train_case):
    pm, before, params_j = train_case["pm"], train_case["before"], train_case["params_j"]
    names = [n for n, _ in pm.named_parameters()]
    _assert_close({n: (pm.get_parameter(n).detach() - before[n]).numpy() for n in names},
                  {n: (params_j[n] - before[n]).numpy() for n in names}, train_case["updates64"],
                  train_case["updates64_branched"], train_case["norms"])


# --- the build ----------------------------------------------------------------

def test_reference_names_load_under_base(tmp_path):
    cfg, _ = nusc_cfgs()
    model = build_model(cfg)
    assert isinstance(model, NuscenesDD3D) and model.strides == STRIDES
    sd = {k: torch.from_numpy(v) for k, v in nusc_state_dict(seed=3).items()}
    renamed = reference_to_port_names(sd, model)
    assert "base.fcos2d_head.cls_logits.weight" in renamed and "attr_logits.weight" in renamed
    model.load_state_dict(renamed, strict=True)
    torch.testing.assert_close(model.speed.weight, sd["speed.weight"], rtol=0, atol=0)
    quant = {m.quant_path for m in model.modules() if getattr(m, "quant_path", None)}
    assert "base/fcos2d_head/cls_tower_conv0" in quant and "attr_logits" in quant


def test_nusc_v99_builds_and_serves():
    cfg = get_experiment_cfg("dd3d_nusc_v99")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.FE.BACKBONE.NAME = "V-19-slim-eSE"  # V-99-eSE differs in block counts (tests/test_torch_vovnet.py)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert model.strides == (8, 16, 32, 64)
    images = (np.random.RandomState(0).rand(6, 128, 128, 3) * 255).astype(np.uint8)
    det = get_inference_fn(model, cfg, group_size=6)(images, np.stack([NUSC_K] * 6),
                                                     np.tile(np.float32([1, 0, 0, 0]), (6, 1)), np.zeros((6, 3)))
    assert det["valid"].shape == (6, 100) and det["quat_global"].shape == (6, 100, 4)
    assert all(torch.isfinite(v.float()).all() for v in det.values())


def test_int8_nuscenes_serving_raises():
    cfg, _ = nusc_cfgs()
    cfg.TPU.QUANT_INT8 = True
    with pytest.raises(NotImplementedError, match="QUANT_INT8"):
        build_model(cfg)


def _report(case: dict) -> None:
    """Print the distances the bounds above were set from."""
    pm = case["pm"]
    grads = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    grads_j = {n: g.numpy() for n, g in case["grads_j"].items()}
    flat = lambda d: np.concatenate([d[n].ravel() for n in grads_j])  # noqa: E731
    rel = lambda a, b: np.linalg.norm(flat(a) - flat(b)) / np.linalg.norm(flat(b))  # noqa: E731
    branched = distances_from_oracle(grads, grads_j, case["grads64_branched"])
    plain = distances_from_oracle(grads, grads_j, case["grads64"])
    print(f"{case['norms']}: {len(case['flips'])} ReLU flips, largest {max(case['flips'], default=0.0):.2e}; "
          f"per tensor: port from branched f64 {max(v[0] for v in branched.values()):.2e}, "
          f"port from f64 {max(v[0] for v in plain.values()):.2e}, JAX from f64 {max(v[1] for v in plain.values()):.2e}; "
          f"flat L2: port from branched f64 {rel(grads, case['grads64_branched']):.2e}, "
          f"port from f64 {rel(grads, case['grads64']):.2e}, JAX from f64 {rel(grads_j, case['grads64']):.2e}, "
          f"port from JAX {rel(grads, grads_j):.2e}")


if __name__ == "__main__":  # python -m tests.test_torch_nuscenes: the train step's measured distances
    with torch_threads(4):
        for norms in NORMS:
            _report(make_train_case(norms))
