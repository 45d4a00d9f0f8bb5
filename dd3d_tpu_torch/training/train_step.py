"""The train step, counterpart of dd3d_tpu/training/train_step.py: color
jitter -> forward in the compute dtype (model.train(): live BN on batch
statistics) -> the meta-architecture's losses in f32 (`dd3d_losses`, or
`nuscenes_dd3d_losses` for NuscenesDD3D, `dd3d_dense_depth_losses` for
DD3DDenseDepth, whose model also takes the inverse intrinsics, in f32, and
whose batch carries a sparse GT `depth`) -> backward -> SGD update, and the
metrics. Nothing in the step waits for the host: the metrics stay tensors
on the device, and `loss_finite` replaces a Python-side assert.

Data parallel (a model in DistributedDataParallel, parallel/mesh.py): each
rank's losses are its share of the global-batch losses (the normalizers are
global, models/fcos2d.py), so the backward runs on world_size x the local
total, and DDP's mean of the ranks' gradients is the gradient of the
global-batch loss, as JAX's step over a sharded batch computes it. The
logged losses are the global batch's on every rank (one all-reduce).

SOLVER.ACCUMULATE_GRAD_BATCHES = k > 1 (training/optim.py): each call is a
micro-batch; its backward is scaled by 1/k, the gradients add up in .grad
(DDP's `no_sync` on the k - 1 micro-batches that do not apply, so the
ranks' sums are reduced once), BN statistics update on every micro-batch,
and the update applies on the k-th. `grad_norm` is then that of the
gradient accumulated so far, the applied one on the k-th micro-batch (JAX
reports each micro-batch's own).

int8 quantization is forced off, as in JAX (train_step.py:75-80): the step
runs under a disabled QuantSpec, whatever the model's inference functions
use.

TPU.REMAT recomputes activations in backward (training/remat.py): one
checkpoint around the model's forward, of the policy the key names, as
JAX's step wraps its apply_model in jax.checkpoint (:65-112); the losses are
not recomputed.
"""
import contextlib
from typing import Callable, Dict

import torch

from dd3d_tpu_torch.models.dd3d import dd3d_losses, model_strides
from dd3d_tpu_torch.models.layers import QuantSpec, quant_scope
from dd3d_tpu_torch.ops.color_jitter import apply_color_jitter
from dd3d_tpu_torch.training.optim import Optimizer, global_norm
from dd3d_tpu_torch.training.remat import checkpointed_forward, remat_policy
from dd3d_tpu_torch.utils.comm import all_reduce_sum, get_world_size


def losses_for(cfg) -> Callable:
    """The loss function of MODEL.META_ARCHITECTURE: each meta-architecture
    owns its losses (dd3d_tpu/training/train_step.py:40-53)."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch == "DD3D":
        return dd3d_losses
    if arch == "NuscenesDD3D":
        from dd3d_tpu_torch.models.nuscenes_dd3d import nuscenes_dd3d_losses

        return nuscenes_dd3d_losses
    if arch == "DD3DDenseDepth":
        from dd3d_tpu_torch.models.dense_depth import dd3d_dense_depth_losses

        return dd3d_dense_depth_losses
    raise NotImplementedError(f"training MODEL.META_ARCHITECTURE={arch!r} is not ported")


def make_train_step(cfg, model: torch.nn.Module, optimizer: Optimizer) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """step(batch) -> metrics: one micro-batch, and one update of the
    model's parameters in place every SOLVER.ACCUMULATE_GRAD_BATCHES calls.
    `model` is the model or its DistributedDataParallel wrapper. `batch` is
    the collate_batch schema on the model's device: image (B, H, W, 3) BGR,
    intrinsics, gt_boxes2d, gt_classes, gt_boxes3d, gt_valid, and
    optionally color_jitter (B, 3); NuscenesDD3D's also gt_attributes and
    gt_speeds; DD3DDenseDepth's `depth` (B, H, W)."""
    losses_fn = losses_for(cfg)
    dense_depth = cfg.MODEL.META_ARCHITECTURE == "DD3DDenseDepth"
    policy = remat_policy(str(cfg.TPU.get("REMAT", "none")))
    net = getattr(model, "module", model)
    strides = model_strides(net)
    k = optimizer.accumulate
    scale = get_world_size() / k

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        apply_update = optimizer.mini_step == k - 1
        if optimizer.mini_step == 0:
            optimizer.zero_grad()
        images = batch["image"]
        if "color_jitter" in batch:
            images = apply_color_jitter(images, batch["color_jitter"])
        no_sync = model.no_sync() if hasattr(model, "no_sync") and not apply_update else contextlib.nullcontext()
        with no_sync:
            with quant_scope(QuantSpec()), checkpointed_forward(net, policy):
                if dense_depth:  # dd3d_tpu/training/train_step.py:87-95
                    outputs = model(images, torch.linalg.inv(batch["intrinsics"].float()))
                else:
                    outputs = model(images)
            losses = losses_fn(cfg, outputs, batch, strides)
            total = sum(losses.values())
            (total * scale if scale != 1.0 else total).backward()
        # of the raw gradients, before any clipping; a missing one is zero
        grad_norm = global_norm([p.grad for p in optimizer.params if p.grad is not None])
        if apply_update:
            optimizer.step()
            optimizer.mini_step = 0
        else:
            optimizer.mini_step += 1
        values = all_reduce_sum(torch.stack([v.detach() for v in losses.values()]))
        metrics = dict(zip(losses, values.unbind()))
        metrics["total_loss"] = sum(metrics.values())
        metrics["grad_norm"] = grad_norm
        metrics["loss_finite"] = torch.isfinite(metrics["total_loss"]).float()
        return metrics

    return train_step
