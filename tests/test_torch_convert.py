"""The port's converter (dd3d_tpu_torch/utils/convert_checkpoint.py): a
reference-named state dict goes to the JAX package through its converter
and comes back through the port's, bit for bit, and loads strictly."""
import numpy as np
import pytest
import torch

from dd3d_tpu.models import build_model as build_jax_model
from dd3d_tpu_torch.models import build_model as build_port_model
from dd3d_tpu_torch.utils.convert_checkpoint import convert_flax_variables

from tests.torch_port_util import fp32_cfg, jax_variables, reference_state_dict


@pytest.fixture(scope="module")
def round_trip():
    cfg = fp32_cfg()
    sd = reference_state_dict(seed=7)
    variables = jax_variables(cfg, build_jax_model(cfg), sd)
    model = build_port_model(cfg)
    return sd, variables, model, convert_flax_variables(variables, model)


def test_round_trip_is_exact(round_trip):
    sd, _variables, _model, back = round_trip
    assert set(back) == set(sd)
    for k, v in sd.items():
        got = back[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k  # bit for bit


def test_reference_state_dict_loads_strictly(round_trip):
    sd, _variables, model, back = round_trip
    model.load_state_dict(back, strict=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    assert torch.equal(model.fcos2d_head.cls_tower[3].norm[4].running_var,
                       torch.from_numpy(sd["fcos2d_head.cls_tower.3.norm.4.running_var"]))


def test_strict_conversion_rejects_leftovers_and_shape_mismatch(round_trip):
    _sd, variables, model, _back = round_trip
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((1, 1, 1, 1), np.float32)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="no place"):
        convert_flax_variables(extra, model)
    head = dict(variables["params"]["fcos2d_head"], cls_logits={"kernel": np.zeros((3, 3, 256, 7), np.float32),
                                                                "bias": np.zeros((7,), np.float32)})
    wrong = {"params": dict(variables["params"], fcos2d_head=head), "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="shape"):
        convert_flax_variables(wrong, model)
