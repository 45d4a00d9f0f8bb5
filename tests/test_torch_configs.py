"""The port's own copy of the config tree (dd3d_tpu_torch/configs,
dd3d_tpu_torch/utils/config.py) against the JAX package's (dd3d_tpu/configs,
dd3d_tpu/utils/config.py): every experiment and the defaults equal as nested
dicts, key order, values and their types included, so the two copies cannot
drift apart."""
import pytest

from dd3d_tpu.configs import EXPERIMENTS as JAX_EXPERIMENTS
from dd3d_tpu.configs import get_cfg as jax_get_cfg
from dd3d_tpu.configs import get_experiment_cfg as jax_get_experiment_cfg
from dd3d_tpu_torch.configs import EXPERIMENTS, get_cfg, get_experiment_cfg
from dd3d_tpu_torch.utils.config import CfgNode


def assert_same_tree(port, ref):
    assert repr(port.to_dict()) == repr(ref.to_dict())
    assert port.to_dict() == ref.to_dict()


def test_defaults_equal_the_jax_package():
    assert_same_tree(get_cfg(), jax_get_cfg())


def test_experiment_names_equal_the_jax_package():
    assert list(EXPERIMENTS) == list(JAX_EXPERIMENTS)


@pytest.mark.parametrize("name", list(JAX_EXPERIMENTS))
def test_experiment_equals_the_jax_package(name):
    assert_same_tree(get_experiment_cfg(name), jax_get_experiment_cfg(name))


def test_cfg_node_merge_and_clone():
    """The copy's CfgNode: attribute access, a deep merge into a copy, and
    clones that share nothing."""
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    assert isinstance(cfg.TPU, CfgNode) and cfg.TPU.COMPUTE_DTYPE == cfg["TPU"]["COMPUTE_DTYPE"]
    merged = cfg.merge({"TPU": {"QUANT_INT8": True}, "NEW": {"A": 1}})
    assert merged.TPU.QUANT_INT8 and merged.NEW.A == 1 and merged.TPU.COMPUTE_DTYPE == cfg.TPU.COMPUTE_DTYPE
    assert not cfg.TPU.QUANT_INT8 and "NEW" not in cfg
    clone = cfg.clone()
    clone.INPUT.RESIZE.MIN_SIZE_TEST = 1
    assert cfg.INPUT.RESIZE.MIN_SIZE_TEST == 384
    with pytest.raises(AttributeError):
        cfg.NOT_A_KEY
    with pytest.raises(KeyError, match="Unknown experiment"):
        get_experiment_cfg("no_such_experiment")
