"""Serving entry: images in, fixed-size detections out; the host-side
unpacking of those detections into per-image dicts; and the evaluation loop
over a test loader. Counterpart of dd3d_tpu/models/postprocess.py
(`get_inference_fn`, `unpack_detections`, `inference_on_dataset`).
"""
import queue
import threading
from typing import Dict, List

import numpy as np
import torch


def get_inference_fn(model, cfg, suppress=None, int8_plain: bool = False):
    """A plain callable `infer(images, intrinsics) -> detections`: model
    forward + `dd3d_inference` under `torch.inference_mode()`. `images` is
    (B, H, W, 3) uint8 BGR and `intrinsics` (B, 3, 3); numpy arrays are moved
    to the model's device. PyTorch runs eagerly, so there is no cache of
    compiled programs to key. `suppress` is passed on to `dd3d_inference`.

    The int8 settings (TPU.QUANT_*) are read from `cfg` once, into a
    QuantSpec that is entered around each call only, so functions built
    from one model with different configs never share them. `infer.quant`
    is that spec (its `misses` list the static-scale misses); `int8_plain`
    runs the int8 kernels' plain versions, for checking them on the card."""
    from dd3d_tpu_torch.models.dd3d import dd3d_inference
    from dd3d_tpu_torch.models.layers import quant_scope, quant_spec_from_cfg

    if cfg.DD3D.INFERENCE.get("NUSC_SAMPLE_AGGREGATE", False):
        raise NotImplementedError("DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE is not ported")
    model.eval()
    device = model.pixel_mean.device
    spec = quant_spec_from_cfg(cfg, plain=int8_plain)

    def infer(images, intrinsics):
        with torch.inference_mode(), quant_scope(spec):
            images = torch.as_tensor(images, device=device)
            intrinsics = torch.as_tensor(intrinsics, device=device)
            outputs = model(images)
            return dd3d_inference(cfg, outputs, intrinsics, model.strides, suppress=suppress)

    infer.quant = spec
    return infer


def unpack_detections(det: Dict[str, np.ndarray], batch: Dict[str, np.ndarray], meta: List[dict]) -> List[dict]:
    """Padded (B, D) detections -> one dict per image: 2D boxes rescaled from
    network-input resolution to the original image and clipped, 3D boxes as
    camera-frame (quat, tvec, size)."""
    det = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in det.items()}
    batch_intrinsics = np.asarray(batch["intrinsics"])
    image_sizes = np.asarray(batch["image_size"])

    out = []
    has_3d = "boxes3d_quat" in det
    for i in range(min(det["valid"].shape[0], len(meta))):
        sel = np.where(det["valid"][i])[0]
        cur_h, cur_w = image_sizes[i]
        orig_w = meta[i].get("width") or cur_w
        orig_h = meta[i].get("height") or cur_h
        sx, sy = orig_w / cur_w, orig_h / cur_h

        boxes2d = det["boxes2d"][i][sel] * np.array([sx, sy, sx, sy])
        boxes2d[:, 0::2] = np.clip(boxes2d[:, 0::2], 0, orig_w)
        boxes2d[:, 1::2] = np.clip(boxes2d[:, 1::2], 0, orig_h)
        item = {
            "image_id": meta[i].get("image_id"),
            "sample_id": meta[i].get("sample_id"),
            "classes": det["classes"][i][sel],
            "scores": det["scores"][i][sel],
            "boxes2d": boxes2d,
            "fpn_levels": det["fpn_levels"][i][sel],
        }
        for key in ("pose", "extrinsics"):
            if meta[i].get(key) is not None:
                item[key] = meta[i][key]
        if has_3d:
            quat = det["boxes3d_quat"][i][sel]
            proj_ctr = det["boxes3d_proj_ctr"][i][sel]
            depth = det["boxes3d_depth"][i][sel]
            size = det["boxes3d_size"][i][sel]
            inv_k = np.linalg.inv(batch_intrinsics[i])
            tvec = (np.concatenate([proj_ctr, np.ones_like(depth)], axis=1) @ inv_k.T) * depth
            item.update({
                "scores_3d": det["scores_3d"][i][sel],
                "quat": quat,
                "tvec": tvec,
                "size": size,
                "conf3d": det["conf3d"][i][sel],
                "boxes3d_vec": np.concatenate([quat, tvec, size], axis=1),
            })
        out.append(item)
    return out


def inference_on_dataset(model, cfg, dataloader, evaluators, visualize_dir=None, suppress=None):
    """Run the model over a test loader of (batch, meta), feed the
    evaluators, and return their merged results (cf. d2's
    inference_on_dataset as scripts/train.py:196 uses it). A producer
    thread runs the loader two batches ahead, so mapping overlaps the
    forward; an exception in the loader is raised here. `model` may be a
    DistributedDataParallel wrapper: its module runs. Each rank evaluates the
    batches of its own loader on its own card, and every rank must reach
    the evaluators' `evaluate` (a gather). `suppress` is passed on to
    `get_inference_fn`.

    The prediction visualization (`visualize_dir`) is not ported: set, it
    raises."""
    if visualize_dir is not None:
        raise NotImplementedError("visualize_dir: the prediction visualization is not ported (the visualizers, "
                                  "ROADMAP §1 item 3)")
    infer = get_inference_fn(getattr(model, "module", model), cfg, suppress=suppress)
    for ev in evaluators:
        ev.reset()

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for item in dataloader:
                if stop.is_set():
                    return
                put(item)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            batch, meta = item
            det = infer(batch["image"], batch["intrinsics"])
            per_image = unpack_detections(det, batch, meta)
            for ev in evaluators:
                ev.process(per_image)
    finally:
        stop.set()
        thread.join(timeout=5)

    results = {}
    for ev in evaluators:
        r = ev.evaluate()
        if r:
            results.update(r)
    return results
