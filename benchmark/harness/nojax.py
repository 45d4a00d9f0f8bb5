"""The check that the measured process never loaded JAX or the JAX package:
top-level module names compared whole, so `dd3d_tpu_torch` passes and
`dd3d_tpu` does not."""
import sys

BANNED = ("jax", "jaxlib", "flax", "dd3d_tpu")


def loaded(modules=None):
    """The banned top-level names among `modules` (default sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(BANNED))
