"""Distributed communication helpers on torch.distributed: the counterpart of
dd3d_tpu/utils/comm.py, which maps the reference's NCCL/MPI/Gloo stack
(tridet/utils/comm.py, SURVEY.md §2.9) onto jax.distributed.

| reference                          | here                                     |
|------------------------------------|------------------------------------------|
| mpirun + NCCL process group        | init_distributed (torchrun's environment)|
| MPI object bcast (:19-50)          | broadcast_from_master                    |
| gather_dict (:71-88)               | gather_dict (all_gather_object)          |
| reduce_sum all-reduce (:91-100)    | all_reduce_sum                           |

One process a card: NCCL on the card, gloo on the CPU. Without a process
group every helper is the single-process identity. `resolve_device` gives an
entry point its device: the card unless the caller asks for the CPU.
"""
import functools
import logging
import os
from datetime import timedelta
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card (under torchrun, the
    card of LOCAL_RANK). Raises when the card is asked for and there is none:
    the CPU is used only when the caller asks for it."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device 'cpu' (--device cpu) to run on the CPU")
    return device


def init_distributed(device: torch.device, timeout_s: float = 1800.0) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL for a card, gloo for
    the CPU, and `torch.cuda.set_device` to the card. Returns whether a group
    was joined; a process started without that environment runs alone."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    LOG.info("process group: rank %d of %d (%s)", get_rank(), get_world_size(), dist.get_backend())
    return True


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_distributed() -> bool:
    """cf. tridet/utils/comm.py:15."""
    return get_world_size() > 1


def is_main_process() -> bool:
    return get_rank() == 0


def master_only(fn):
    """Decorator: run only on rank 0 (tridet/utils/comm.py:53-68)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


def broadcast_from_master(obj: Any) -> Any:
    """A picklable object from rank 0 on every rank (tridet/utils/comm.py:19-50)."""
    if not is_distributed():
        return obj
    box = [obj if is_main_process() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_objects(obj: Any) -> list:
    """Every rank's picklable object, in rank order, on every rank (the MPI
    allgather of tridet/data/build.py:214 and the eval gathers)."""
    if not is_distributed():
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_dict(d: Dict) -> Dict:
    """Merge per-rank dicts onto every rank (tridet/utils/comm.py:71-88)."""
    merged = {}
    for part in all_gather_objects(d):
        merged.update(part)
    return merged


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, as a new tensor, outside autograd (the
    reference's reduce_sum, tridet/utils/comm.py:91-100); `t` itself without
    a process group."""
    if not dist.is_initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def raise_if_any_rank_failed(error: Optional[BaseException]) -> None:
    """The agreement every rank joins after its local part of a test
    (inference, the evaluators' `process`) and before the evaluators'
    gather: each rank's error or None goes to every rank. Where one failed,
    every rank raises the same RuntimeError (naming the first failed rank),
    so that all skip the gather together and none waits in it. Without a
    process group, `error` itself is raised."""
    if not is_distributed():
        if error is not None:
            raise error
        return
    failed = [(r, e) for r, e in enumerate(all_gather_objects(None if error is None else repr(error))) if e]
    if failed:
        rank, what = failed[0]
        raise RuntimeError(f"the test failed on rank {rank} of {get_world_size()}: {what}") from error


def cleanup() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
