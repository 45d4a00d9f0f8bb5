"""Data parallelism on torch.distributed: the counterpart of
dd3d_tpu/parallel/mesh.py, which jits a global-batch step over a device
mesh so that XLA inserts the all-reduces.

The reference's distribution model is data parallelism (SURVEY.md §2.9,
§5.8): DistributedDataParallel's gradient all-reduce (scripts/train.py:67-72),
SyncBatchNorm's cross-replica statistics (:63-66) and `reduce_sum` loss
normalizers (tridet/utils/comm.py:91-100). Here, one process a card:
- `wrap_model` puts the model in DistributedDataParallel (gradients averaged
  over the ranks while backward runs);
- the live BN of FCOS2D combines the ranks' statistics itself
  (models/layers.py::FoldableBatchNorm), so DDP does not broadcast buffers;
- the loss normalizers are summed over the ranks (models/fcos2d.py);
- each rank's loader yields its local batch, which the training loop's
  `device_prefetch` places on the rank's card.
Without a process group the model runs as it is.
"""
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def wrap_model(model: torch.nn.Module) -> torch.nn.Module:
    """`model` in DistributedDataParallel when a process group is initialized
    (whatever its size), else `model` itself. One card a rank: the model's
    parameters must already lie on it."""
    if not dist.is_initialized():
        return model
    device = next(model.parameters()).device
    return DistributedDataParallel(model, device_ids=[device] if device.type == "cuda" else None,
                                   broadcast_buffers=False)
