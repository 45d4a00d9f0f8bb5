"""dd3d_tpu_torch — the PyTorch/CUDA port of dd3d_tpu's serving path.

The JAX package `dd3d_tpu` is the reference this port is held against
(tests/test_torch_*.py). Module names mirror it: `dd3d_tpu/models/fcos2d.py`
has its counterpart at `dd3d_tpu_torch/models/fcos2d.py`.

This package imports torch and never jax or flax. It reads the JAX package's
config tree (`dd3d_tpu.configs`, plain Python) through `dd3d_tpu_torch.configs`.
"""

__version__ = "0.1.0"
