"""The train step, counterpart of dd3d_tpu/training/train_step.py: color
jitter -> forward in the compute dtype (model.train(): live BN on batch
statistics) -> `dd3d_losses` in f32 -> backward -> SGD update, and the
metrics. Nothing in the step waits for the host: the metrics stay tensors
on the device, and `loss_finite` replaces a Python-side assert.

int8 quantization is forced off, as in JAX (train_step.py:75-80): the step
runs under a disabled QuantSpec, whatever the model's inference functions
use. TPU.REMAT (activation recomputation) is not ported: anything but
"none" raises.
"""
from typing import Callable, Dict

import torch

from dd3d_tpu_torch.models.dd3d import dd3d_losses, model_strides
from dd3d_tpu_torch.models.layers import QuantSpec, quant_scope
from dd3d_tpu_torch.ops.color_jitter import apply_color_jitter
from dd3d_tpu_torch.training.optim import Optimizer, global_norm


def make_train_step(cfg, model: torch.nn.Module, optimizer: Optimizer) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """step(batch) -> metrics: one update of `model` in place. `batch` is the
    collate_batch schema on the model's device: image (B, H, W, 3) BGR,
    intrinsics, gt_boxes2d, gt_classes, gt_boxes3d, gt_valid, and
    optionally color_jitter (B, 3)."""
    if cfg.MODEL.META_ARCHITECTURE != "DD3D":
        raise NotImplementedError(f"training MODEL.META_ARCHITECTURE={cfg.MODEL.META_ARCHITECTURE!r} is not ported")
    remat = str(cfg.TPU.get("REMAT", "none"))
    if remat not in ("none", ""):
        raise NotImplementedError(f"TPU.REMAT={remat!r} is not ported; the port stores all activations")
    strides = model_strides(model)

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        images = batch["image"]
        if "color_jitter" in batch:
            images = apply_color_jitter(images, batch["color_jitter"])
        with quant_scope(QuantSpec()):
            outputs = model(images)
        losses = dd3d_losses(cfg, outputs, batch, strides)
        total = sum(losses.values())
        optimizer.zero_grad()
        total.backward()
        # of the raw gradients, before any clipping; a missing one is zero
        grad_norm = global_norm([p.grad for p in optimizer.params if p.grad is not None])
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        metrics["loss_finite"] = torch.isfinite(total.detach()).float()
        return metrics

    return train_step
