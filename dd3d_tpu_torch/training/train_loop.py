"""The training loop, counterpart of dd3d_tpu/training/train_loop.py: batches
moved to the card by a background thread (`device_prefetch`: pinned memory,
non-blocking copies on a side stream), the model in DistributedDataParallel
when a process group is initialized (parallel/mesh.py), the train step,
scalar metrics every `log_period` (the only host sync) into
`<output_dir>/metrics.jsonl` on rank 0 (utils/events.py), checkpoints every
SOLVER.CHECKPOINT_PERIOD saved on rank 0 and restored on every rank, the
eval hook every TEST.EVAL_PERIOD, a raise when the loss diverges, and, on
rank 0 of a run with an output directory, the dataloader visualization
(VIS.DATALOADER_ENABLED) every VIS.DATALOADER_PERIOD steps.
"""
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.parallel.mesh import wrap_model
from dd3d_tpu_torch.training.checkpoint import CheckpointManager
from dd3d_tpu_torch.training.optim import Optimizer
from dd3d_tpu_torch.training.train_step import make_train_step
from dd3d_tpu_torch.utils.comm import get_world_size, is_main_process, resolve_device
from dd3d_tpu_torch.utils.events import EventStorage

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


def device_prefetch(data_iter: Iterable, device: torch.device, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches on `device`, moved by a background thread `depth` ahead: on a
    card, from pinned host memory with non-blocking copies on a side stream
    that the consuming stream waits for, so the copy of the next batch
    overlaps the running step. Closing the generator stops the thread and
    closes `data_iter` (the loader's pool shuts down with it)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        if not cuda:
            return to_device(batch, device), None
        with torch.cuda.stream(copy_stream):
            moved = {k: torch.as_tensor(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return moved, done

    def worker():
        try:
            for batch in data_iter:
                if stop.is_set():
                    return
                item = put(batch)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)
        finally:
            q.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in batch.values():
                    t.record_stream(stream)  # the copy stream's memory is now used here
            yield batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5)
        close_iterator(data_iter)


def close_iterator(it) -> None:
    """Close a generator (its `finally` shuts a loader's pool down), if it
    is one and no thread is inside it."""
    close = getattr(it, "close", None)
    if close is not None:
        try:
            close()
        except (RuntimeError, ValueError):
            pass  # still running in a worker thread; it exits via its stop event


def _visualize_train_batch(batch, output_dir, storage, max_n: int, step: int) -> None:
    """Draw the ground-truth 2D boxes and 3D wireframes of the first `max_n`
    images of a train batch into `<output_dir>/visualization/
    dataloader_step{step:06d}_{i}.png`, and hand each drawing to
    `storage.put_image` (dd3d_tpu/training/train_loop.py:91-128; the
    reference's periodic dataloader visualization, scripts/train.py:168-183).
    The 10-vector ground truth is decoded through the inverse intrinsics:
    tvec = K^-1 [u, v, 1] * depth."""
    import os

    from dd3d_tpu_torch.visualizers.draw import draw_boxes2d, draw_boxes3d, save_vis

    def fetch(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    imgs = fetch(batch["image"])
    boxes2d = fetch(batch["gt_boxes2d"])
    classes = fetch(batch["gt_classes"])
    boxes3d = fetch(batch["gt_boxes3d"])
    valid = fetch(batch["gt_valid"])
    intrinsics = fetch(batch["intrinsics"])

    vis_dir = os.path.join(output_dir, "visualization")
    for i in range(min(max_n, len(imgs))):
        sel = valid[i].astype(bool)
        img = np.clip(imgs[i], 0, 255).astype(np.uint8)
        vis = draw_boxes2d(img, boxes2d[i][sel], classes[i][sel])
        vec = boxes3d[i][sel]
        if vec.shape[-1] == 10:
            inv_k = np.linalg.inv(intrinsics[i].astype(np.float64))
            uv1 = np.concatenate([vec[:, 4:6], np.ones((len(vec), 1))], axis=1)
            tvec = (uv1 @ inv_k.T) * vec[:, 6:7]
            vis = draw_boxes3d(vis, vec[:, :4], tvec, vec[:, 7:10], intrinsics[i], classes[i][sel])
        save_vis(vis, vis_dir, f"dataloader_step{step:06d}_{i}")
        if storage is not None:
            storage.put_image(f"dataloader/{i}", vis, caption=f"step={step}")


def train(cfg, data_iter: Iterable, model: Optional[torch.nn.Module] = None, state: Optional[TrainState] = None,
          device=None, max_iter: Optional[int] = None, log_period: int = 20, output_dir: Optional[str] = None,
          eval_hook: Optional[Callable] = None, metric_hook: Optional[Callable] = None) -> TrainState:
    """Run the training loop; returns the final TrainState. `device` defaults
    to the card (resolve_device: "cpu" must be asked for). With
    `output_dir`, checkpoints go to `<output_dir>/ckpt`, a run resumes from
    the latest one there, and rank 0 writes `<output_dir>/metrics.jsonl`.
    With a process group the model trains in DistributedDataParallel and
    `data_iter` yields this rank's local batches."""
    max_iter = max_iter or cfg.SOLVER.MAX_ITER
    if state is None:
        device = resolve_device(device)
        state = create_train_state(cfg, model if model is not None else build_model(cfg), device)
    device = next(state.model.parameters()).device

    ckpt = CheckpointManager(f"{output_dir}/ckpt", max_to_keep=5) if output_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        state.step = ckpt.restore(state.model, state.optimizer)
        LOG.info("Resumed from checkpoint step %d", state.step)

    step_fn = make_train_step(cfg, wrap_model(state.model), state.optimizer)
    storage = EventStorage(output_dir, wandb_enabled=bool(cfg.get("WANDB", {}).get("ENABLED", False))) \
        if output_dir and is_main_process() else None
    world = get_world_size()
    vis_cfg = cfg.get("VIS", {})
    vis_period = int(vis_cfg.get("DATALOADER_PERIOD", 0)) \
        if output_dir and bool(vis_cfg.get("DATALOADER_ENABLED", False)) and is_main_process() else 0
    source = iter(data_iter)
    dev_iter = device_prefetch(itertools.islice(source, max(max_iter - state.step, 0)), device)
    try:
        t0 = time.time()
        window_imgs = 0
        for it in range(state.step, max_iter):
            try:
                batch = next(dev_iter)
            except StopIteration:
                break
            metrics = step_fn(batch)
            state.step = it + 1
            window_imgs += int(batch["image"].shape[0]) * world

            if (it + 1) % log_period == 0 or it + 1 == max_iter:
                m = {k: float(v) for k, v in metrics.items()}
                ips = window_imgs / max(time.time() - t0, 1e-9)
                LOG.info("iter %d/%d total=%.4f imgs/s=%.1f %s", it + 1, max_iter, m["total_loss"], ips,
                         " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()) if k.startswith("loss")))
                if metric_hook is not None:
                    metric_hook(it + 1, {**m, "imgs_per_sec": ips})
                if storage is not None:
                    storage.put_scalars(it + 1, **m, imgs_per_sec=ips)
                if not np.isfinite(m["total_loss"]):
                    raise FloatingPointError(f"Loss diverged at iter {it + 1}: {m}")
                t0 = time.time()
                window_imgs = 0

            if vis_period > 0 and (it + 1) % vis_period == 0:
                _visualize_train_batch(batch, output_dir, storage,
                                       max_n=int(vis_cfg.get("DATALOADER_MAX_NUM_SAMPLES", 10)), step=it + 1)
            if ckpt is not None and is_main_process() and (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                ckpt.save(it + 1, state.model, state.optimizer)
            if eval_hook is not None and (it + 1) % cfg.TEST.EVAL_PERIOD == 0:
                eval_hook(it + 1, state)
    finally:
        dev_iter.close()
        close_iterator(source)
        if storage is not None:
            storage.close()

    if ckpt is not None and is_main_process():
        ckpt.save(state.step, state.model, state.optimizer)
    return state
