"""Shared set-up of the port's parity tests (tests/test_torch_*.py): one
reference-named state dict with random values, loaded into both the JAX
package (through its converter) and the PyTorch port (through the port's
converter), at fp32."""
import contextlib
import math
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dd3d_tpu.configs import get_experiment_cfg
from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu.utils.convert_checkpoint import convert_torch_state_dict
from dd3d_tpu_torch.models import build_model as build_port_model
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables

from tests.torch_ref_dd3d import FPN, FCOS2DHead, FCOS3DHead, TorchDD3D, TorchVoVNet, randomize_state


def fp32_cfg():
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def reference_state_dict(seed: int = 7):
    """{name: np.ndarray} of the reference graph with every value randomized."""
    tm = TorchDD3D()
    randomize_state(tm, seed=seed)
    return {k: v.numpy().copy() for k, v in tm.state_dict().items()}


PREDICTORS = ("cls_logits", "box2d_reg", "centerness", "box3d_quat", "box3d_ctr", "box3d_depth", "box3d_size",
              "box3d_conf")


def detection_state_dict(seed: int = 7):
    """A reference state dict whose detections are well conditioned: with
    `randomize_state` alone (weights of std 0.1) the input signal dies out in
    the backbone and the score maps are flat, so many scores tie to 1e-7.
    Here the trunk, FPN and tower convs get He-scaled weights and unit-centred
    norm scales, so features carry the image; the predictors are scaled down
    to logits of std ~3; and the box regression gets +4 so 2D boxes span
    8 strides and NMS has overlaps to resolve."""
    return condition_for_detection(reference_state_dict(seed))


class TorchKittiVoVNetDD3D(torch.nn.Module):
    """Reference-named DD3D for the dd3d_kitti_v99 experiment, from the
    reference mirrors of tests/torch_ref_dd3d.py: a VoVNet trunk (any
    non-depthwise preset), FPN with the P6 top, the heads at P3-P6, and the
    five KITTI depth statistics (the reference sizes the depth Scale/Offset
    lists by them, so it carries a fifth pair no level reads)."""

    def __init__(self, spec, num_classes=5, mean_depth=(32.594, 15.178, 8.424, 5.004, 4.662),
                 std_depth=(14.682, 7.139, 4.345, 2.399, 2.587)):
        super().__init__()
        strides = [8, 16, 32, 64]
        trunk = TorchVoVNet(spec["stem"], spec["stage_conv_ch"], spec["stage_out_ch"], spec["block_per_stage"],
                            spec["layer_per_block"])
        ch = {f"stage{i + 2}": spec["stage_out_ch"][i] for i in range(4)}
        self.backbone = FPN(trunk, ["stage3", "stage4", "stage5"], ch, 256,
                            strides={"stage3": 8, "stage4": 16, "stage5": 32}, top="p6")
        self.fcos2d_head = FCOS2DHead(num_classes, 256, strides)
        self.fcos3d_head = FCOS3DHead(num_classes, 256, strides, mean_depth, std_depth)
        self.register_buffer("pixel_mean", torch.tensor([103.530, 116.280, 123.675]).view(1, 3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor([57.375, 57.120, 58.395]).view(1, 3, 1, 1))


def v99_cfg(backbone: str = "V-19-slim-eSE"):
    """dd3d_kitti_v99 at fp32 with another VoVNet preset."""
    cfg = get_experiment_cfg("dd3d_kitti_v99")
    cfg.FE.BACKBONE.NAME = backbone
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def v99_state_dict(backbone: str = "V-19-slim-eSE", seed: int = 7):
    """A reference-named dd3d_kitti_v99 state dict, conditioned for
    detection (`condition_for_detection`)."""
    from dd3d_tpu.models.vovnet import VOVNET_SPECS

    tm = TorchKittiVoVNetDD3D(VOVNET_SPECS[backbone])
    randomize_state(tm, seed=seed)
    return condition_for_detection({k: v.numpy().copy() for k, v in tm.state_dict().items()})


def nusc_state_dict(seed: int = 7):
    """A reference-named NuscenesDD3D state dict for dd3d_nusc_dla34 (10
    classes, the nuScenes depth statistics), conditioned for detection: the
    DD3D graph of tests/torch_ref_dd3d.py at the root, as the reference
    keeps it, and the attribute (4) and speed (1) predictors beside it."""
    from dd3d_tpu.configs import get_experiment_cfg as jax_experiment

    c3 = jax_experiment("dd3d_nusc_dla34").DD3D.FCOS3D
    tm = TorchDD3D(num_classes=10, mean_depth=tuple(c3.MEAN_DEPTH_PER_LEVEL), std_depth=tuple(c3.STD_DEPTH_PER_LEVEL))
    randomize_state(tm, seed=seed)
    sd = condition_for_detection({k: v.numpy().copy() for k, v in tm.state_dict().items()})
    rng = np.random.RandomState(seed)
    for name, out in (("attr_logits", 4), ("speed", 1)):
        sd[f"{name}.weight"] = (rng.randn(out, 256, 3, 3) * 1e-5).astype(np.float32)  # as the other predictors
        sd[f"{name}.bias"] = (rng.randn(out) * 0.1 + (0.5 if name == "speed" else 0.0)).astype(np.float32)
    return sd


def condition_for_detection(sd):
    """`detection_state_dict`'s scaling of a reference state dict."""
    sd = dict(sd)
    for k, v in sd.items():
        if v.ndim == 4 and k.endswith(".weight"):
            fan_in = np.prod(v.shape[1:])
            sd[k] = v * 1e-4 if k.split(".")[1] in PREDICTORS else v * (np.sqrt(2.0 / fan_in) / 0.1)
        elif (".norm." in k or "/norm." in k) and k.endswith(".weight"):  # VoVNet's: `stem_1/norm.weight`
            sd[k] = v + 1.0
    sd["fcos2d_head.box2d_reg.bias"] = sd["fcos2d_head.box2d_reg.bias"] + 4.0
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in sd.items()}


def seed_flax_variables(variables, seed, norm_scale=1.0):
    """JAX variables with flax's initial kernels and learnable Scale/Offset
    values, and every norm statistic, norm affine and conv bias drawn from
    `seed`: norm scales about `norm_scale`, variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    draw = {"bias": lambda a: rng.randn(*a.shape) * 0.1, "scale": lambda a: norm_scale + rng.randn(*a.shape) * 0.1,
            "mean": lambda a: rng.randn(*a.shape) * 0.1, "var": lambda a: rng.rand(*a.shape) + 0.5}

    def walk(tree, in_norm):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_norm or k.startswith("norm"))
            else:
                drawn = (k in ("mean", "var") or (in_norm and k in ("scale", "bias"))
                         or (k == "bias" and "kernel" in tree))
                out[k] = np.asarray(draw[k](v) if drawn else v, np.float32)
        return out

    return {c: walk(jax.tree_util.tree_map(np.asarray, dict(t)), False) for c, t in variables.items()}


def jax_variables(cfg, model, sd):
    """The JAX model's {"params", "batch_stats"} holding `sd` (shapes from an
    abstract init, so nothing is compiled)."""
    shapes = jax.eval_shape(lambda r, x: model.init(r, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 128, 256, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, batch_stats = convert_torch_state_dict(sd, zeros, strict=True)
    return {"params": params, "batch_stats": batch_stats}


def both_models(cfg, sd=None):
    """(jax_model, jax_variables, port_model) with the same weights
    (default: `reference_state_dict()`)."""
    jm = build_jax_model(cfg)
    variables = jax_variables(cfg, jm, reference_state_dict() if sd is None else sd)
    pm = build_port_model(cfg)
    pm.load_state_dict(convert_flax_variables(variables, pm), strict=True)
    return jm, variables, pm


def to_torch_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


@contextlib.contextmanager
def jax_quant_globals_restored():
    """The JAX package's int8 settings are module globals that its jitted
    closures set while tracing and leave set (dd3d_tpu/models/layers.py
    QUANT_*); put every one of them back afterwards."""
    import dd3d_tpu.models.layers as jl

    names = ("QUANT_INT8", "QUANT_MIN_CH", "QUANT_UNFOLDED", "QUANT_SCALES", "QUANT_OBSERVED_TAGS",
             "QUANT_SCALE_MISSES")
    saved = {n: getattr(jl, n) for n in names}
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(jl, n, v)


@contextlib.contextmanager
def torch_threads(n: int = 2):
    """Cap PyTorch's intra-op threads: the driver runs test files in several
    processes at once, and a process of 8 spinning OpenMP threads each makes
    the f64 GEMMs of the plain int8 conv a hundred times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(n, before))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gloo(fn, world: int, *args, out_dir, timeout_s: float = 240.0, join_group: bool = True):
    """Run `fn(*args)` in `world` processes spawned by torch.multiprocessing,
    joined in a gloo process group on a free localhost port (rendezvous
    bounded by tests/torch_dist_workers.RENDEZVOUS_TIMEOUT_S), and return
    their results in rank order. `fn` lives in tests/torch_dist_workers.py
    (no jax in the spawned processes). With `join_group=False` the body joins
    the group itself from torchrun's environment variables, which are set
    either way. Raises if a process fails, or if they have not all ended
    within `timeout_s`, after killing them."""
    import torch.multiprocessing as mp

    from tests.torch_dist_workers import _child

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.spawn(_child, args=(world, free_port(), str(out_dir), fn, args, join_group), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} gloo ranks did not end within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def assert_identical(got, want, what=""):
    """Evaluation results equal key for key and value for value (NaN equals
    NaN: a COCO area range without ground truth reads NaN on both sides)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), what
        for k in want:
            assert_identical(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_identical(g, w, f"{what}/{i}")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), what
    else:
        assert got == want, (what, got, want)
