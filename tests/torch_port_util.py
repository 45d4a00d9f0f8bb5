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

from tests.torch_ref_dd3d import TorchDD3D, randomize_state


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
    sd = reference_state_dict(seed)
    for k, v in sd.items():
        if v.ndim == 4 and k.endswith(".weight"):
            fan_in = np.prod(v.shape[1:])
            sd[k] = v * 1e-4 if k.split(".")[1] in PREDICTORS else v * (np.sqrt(2.0 / fan_in) / 0.1)
        elif ".norm." in k and k.endswith(".weight"):
            sd[k] = v + 1.0
    sd["fcos2d_head.box2d_reg.bias"] = sd["fcos2d_head.box2d_reg.bias"] + 4.0
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in sd.items()}


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
