"""TPU.REMAT, activation recomputation in the train step: counterpart of
dd3d_tpu/training/train_step.py:65-112, which wraps the model's apply in
jax.checkpoint, plain ("full") or with a policy of jax.checkpoint_policies
named by the key.

As in JAX, one checkpoint (torch.utils.checkpoint, non-reentrant) covers the
model's forward, never the losses. The names of jax.checkpoint_policies map
as follows (`POLICIES`):
- "none", "" and "everything_saveable": no checkpoint, every activation
  stays (JAX's everything_saveable is the step without jax.checkpoint).
- "full" and "nothing_saveable": the whole forward runs again in backward.
- "dots_saveable" and "checkpoint_dots": the outputs of convolutions and
  matrix products are saved and the rest is recomputed (selective
  checkpointing); JAX's policy saves dot_general and conv_general_dilated.
- "dots_with_no_batch_dims_saveable" and
  "checkpoint_dots_with_no_batch_dims": only 2-D matrix products (dot_general
  without batch dimensions in JAX) are saved. No model of the repo has one:
  the jaxpr of JAX's train-mode forward of dd3d_kitti_dla34, dd3d_nusc_dla34,
  DD3DDenseDepth, dd3d_kitti_v99 and dd3d_kitti_regnety_006_bifpn holds 0
  dot_general beside 70-206 conv_general_dilated, so this policy recomputes
  everything, as "full" does.
- The factories of jax.checkpoint_policies (`FACTORIES`) take arguments and
  fail in JAX when the key names one as the policy itself: NotImplementedError.
- Any other name: ValueError, as JAX's step raises.

The recompute runs in backward, where two things differ from the first
forward, and `checkpointed_forward` restores the first forward's view:
- The forward updates state: live BN's running averages. JAX's batch_stats
  come out of the checkpoint once, so the recompute leaves them alone: it
  runs with `models.layers.RECOMPUTING` set, which FoldableBatchNorm reads.
  Under SyncBN it issues the same all-reduces as the first forward, on every
  rank alike (each rank recomputes the same graph).
- On the GPU, autograd runs backward on its own device thread, where the
  context variables set around the forward (the QuantSpec of `quant_scope`,
  and any other) are unset. The recompute runs under the values captured at
  the first forward.
"""
import contextlib
import contextvars
import functools
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from dd3d_tpu_torch.models.layers import RECOMPUTING

_aten = torch.ops.aten
_MATMULS_2D = (_aten.mm.default, _aten.addmm.default)
_CONVS_AND_MATMULS = (_aten.convolution.default, *_MATMULS_2D, _aten.bmm.default, _aten.baddbmm.default)

FULL = "full"
# TPU.REMAT -> None (no checkpoint), FULL, or the aten ops whose outputs are saved.
POLICIES = {
    "none": None,
    "": None,
    "everything_saveable": None,
    "full": FULL,
    "nothing_saveable": FULL,
    "dots_saveable": _CONVS_AND_MATMULS,
    "checkpoint_dots": _CONVS_AND_MATMULS,
    "dots_with_no_batch_dims_saveable": _MATMULS_2D,
    "checkpoint_dots_with_no_batch_dims": _MATMULS_2D,
}
FACTORIES = ("save_only_these_names", "save_anything_except_these_names", "save_any_names_but_these",
             "save_and_offload_only_these_names", "save_from_both_policies", "offload_dot_with_no_batch_dims")


def remat_policy(name: str):
    """The policy of TPU.REMAT = `name`: None, FULL or a tuple of aten ops."""
    if name in POLICIES:
        return POLICIES[name]
    if name in FACTORIES:
        raise NotImplementedError(f"TPU.REMAT={name!r} is a factory of jax.checkpoint_policies that takes "
                                  "arguments; JAX's step fails on it as a policy, and the port does not read it")
    raise ValueError(f"Unknown TPU.REMAT policy {name!r}")


@contextlib.contextmanager
def _as_first_forward(captured: contextvars.Context, inner):
    """The recompute's context: the first forward's context variables, with
    RECOMPUTING set, around `inner` (selective checkpointing's recompute
    mode, or nothing)."""
    tokens = [(var, var.set(value)) for var, value in captured.items()]
    tokens.append((RECOMPUTING, RECOMPUTING.set(True)))
    try:
        with inner:
            yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


def _checkpoint_call(forward, policy, *args):
    captured = contextvars.copy_context()

    def context_fn() -> Tuple:
        if policy == FULL:
            first, again = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            first, again = create_selective_checkpoint_contexts(list(policy))
        return first, _as_first_forward(captured, again)

    return checkpoint(forward, *args, use_reentrant=False, context_fn=context_fn)


@contextlib.contextmanager
def checkpointed_forward(module: torch.nn.Module, policy):
    """Inside, a call of `module` runs its forward under one checkpoint of
    `policy` (from `remat_policy`; None: as it is). `module` is the model
    itself, also under DistributedDataParallel, whose forward calls it: the
    wrapper's own forward (its reducer and buffer broadcasts) runs once, and
    only the model's is recomputed."""
    if policy is None:
        yield
        return
    own: Optional[object] = module.__dict__.get("forward")
    module.forward = functools.partial(_checkpoint_call, module.forward, policy)
    try:
        yield
    finally:
        if own is None:
            del module.forward
        else:
            module.forward = own
