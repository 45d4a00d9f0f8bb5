"""The training loop, counterpart of dd3d_tpu/training/train_loop.py on one
card: batches moved to an explicit device, the train step, scalar metrics
every `log_period` (the only host sync), checkpoints every
SOLVER.CHECKPOINT_PERIOD, the eval hook every TEST.EVAL_PERIOD, and a raise
when the loss diverges. There is no mesh: DDP, the loader with torch ranks
and the dataloader visualization are not ported.
"""
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.training.checkpoint import CheckpointManager
from dd3d_tpu_torch.training.optim import Optimizer
from dd3d_tpu_torch.training.train_step import make_train_step

LOG = logging.getLogger(__name__)


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer


def create_train_state(cfg, model: torch.nn.Module, device) -> TrainState:
    """The model on `device` in train mode, and its optimizer at step 0."""
    model = model.to(device).train()
    return TrainState(0, model, Optimizer(cfg, model))


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A collate_batch dict (numpy arrays or tensors) on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def train(cfg, data_iter: Iterable, model: Optional[torch.nn.Module] = None, state: Optional[TrainState] = None,
          device=None, max_iter: Optional[int] = None, log_period: int = 20, output_dir: Optional[str] = None,
          eval_hook: Optional[Callable] = None, metric_hook: Optional[Callable] = None) -> TrainState:
    """Run the training loop; returns the final TrainState. With
    `output_dir`, checkpoints go to `<output_dir>/ckpt` and a run resumes
    from the latest one there."""
    if state is None:
        device = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
        state = create_train_state(cfg, model if model is not None else build_model(cfg), device)
    device = next(state.model.parameters()).device
    max_iter = max_iter or cfg.SOLVER.MAX_ITER

    ckpt = CheckpointManager(f"{output_dir}/ckpt", max_to_keep=5) if output_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        state.step = ckpt.restore(state.model, state.optimizer)
        LOG.info("Resumed from checkpoint step %d", state.step)

    step_fn = make_train_step(cfg, state.model, state.optimizer)
    data_iter = iter(data_iter)
    t0 = time.time()
    window_imgs = 0
    for it in range(state.step, max_iter):
        try:
            batch = to_device(next(data_iter), device)
        except StopIteration:
            break
        metrics = step_fn(batch)
        state.step = it + 1
        window_imgs += int(batch["image"].shape[0])

        if (it + 1) % log_period == 0 or it + 1 == max_iter:
            m = {k: float(v) for k, v in metrics.items()}
            ips = window_imgs / max(time.time() - t0, 1e-9)
            LOG.info("iter %d/%d total=%.4f imgs/s=%.1f %s", it + 1, max_iter, m["total_loss"], ips,
                     " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()) if k.startswith("loss")))
            if metric_hook is not None:
                metric_hook(it + 1, {**m, "imgs_per_sec": ips})
            if not np.isfinite(m["total_loss"]):
                raise FloatingPointError(f"Loss diverged at iter {it + 1}: {m}")
            t0 = time.time()
            window_imgs = 0

        if ckpt is not None and (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            ckpt.save(it + 1, state.model, state.optimizer)
        if eval_hook is not None and (it + 1) % cfg.TEST.EVAL_PERIOD == 0:
            eval_hook(it + 1, state)

    if ckpt is not None:
        ckpt.save(state.step, state.model, state.optimizer)
    return state
