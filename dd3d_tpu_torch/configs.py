"""Config tree of the port: the JAX package's own (`dd3d_tpu.configs`), which
is plain Python with no jax import, so both packages read one set of keys."""
from dd3d_tpu.configs import get_cfg, get_experiment_cfg

__all__ = ["get_cfg", "get_experiment_cfg"]
