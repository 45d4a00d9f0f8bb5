"""dd3d_tpu_torch — the PyTorch/CUDA port of dd3d_tpu: serving (bf16 and
static int8), and training from KITTI-format files on one card or several
(`python -m dd3d_tpu_torch.train`).

The JAX package `dd3d_tpu` is the reference this port is held against
(tests/test_torch_*.py). Module names mirror it: `dd3d_tpu/models/fcos2d.py`
has its counterpart at `dd3d_tpu_torch/models/fcos2d.py`.

This package imports torch and never jax, flax or anything of the JAX
package: it keeps its own copy of the config tree (`dd3d_tpu_torch.configs`)
and of the data path (`dd3d_tpu_torch.data`, with its own PNG reader). Its
entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
