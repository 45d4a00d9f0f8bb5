"""Shared set-up of the port's parity tests (tests/test_torch_*.py): one
reference-named state dict with random values, loaded into both the JAX
package (through its converter) and the PyTorch port (through the port's
converter), at fp32."""
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
