"""Config tree of the port: its own copy of the JAX package's
(dd3d_tpu/configs, dd3d_tpu/utils/config.py), with every key and default,
the TPU.* keys included, so that both packages read one set of keys and the
port imports nothing of the JAX package."""
from dd3d_tpu_torch.configs.defaults import get_cfg
from dd3d_tpu_torch.configs.experiments import EXPERIMENTS, get_experiment_cfg

__all__ = ["get_cfg", "get_experiment_cfg", "EXPERIMENTS"]
