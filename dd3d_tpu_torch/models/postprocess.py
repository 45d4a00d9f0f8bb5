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

from dd3d_tpu_torch.utils import comm
from dd3d_tpu_torch.utils.profiling import annotate


def get_inference_fn(model, cfg, suppress=None, int8_plain: bool = False, group_size: int = 1, scan=None):
    """A plain callable `infer(images, intrinsics, pose_quat=None,
    pose_tvec=None) -> detections`: model forward + `dd3d_inference` under
    `torch.inference_mode()`. `images` is (B, H, W, 3) uint8 BGR and
    `intrinsics` (B, 3, 3); numpy arrays are moved to the model's device.
    PyTorch runs eagerly, so there is no cache of compiled programs to key.
    `suppress` (the 2D NMS) and `scan` (the rotated BEV NMS's greedy walk)
    are passed on to `dd3d_inference` and the sample aggregation.

    With DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE, `group_size` > 1 and poses
    (pose_quat (B, 4) camera -> global wxyz, pose_tvec (B, 3)), each run of
    `group_size` images is one sample of that many cameras: its detections
    go through one global BEV NMS (`ops/sample_bev_nms.py`, at most 500 a
    sample, in the span `serve.aggregate`) and carry `quat_global` /
    `tvec_global` (JAX
    dd3d_tpu/models/postprocess.py:125-175; nuscenes_dd3d.py:448-465).

    The int8 settings (TPU.QUANT_*) are read from `cfg` once, into a
    QuantSpec that is entered around each call only, so functions built
    from one model with different configs never share them. `infer.quant`
    is that spec (its `misses` list the static-scale misses); `int8_plain`
    runs the int8 kernels' plain versions, for checking them on the card."""
    from dd3d_tpu_torch.models.dd3d import dd3d_inference
    from dd3d_tpu_torch.models.layers import quant_scope, quant_spec_from_cfg
    from dd3d_tpu_torch.ops.sample_bev_nms import sample_bev_nms_in_graph

    model.eval()
    device = model.pixel_mean.device
    spec = quant_spec_from_cfg(cfg, plain=int8_plain)
    aggregate = bool(cfg.DD3D.INFERENCE.get("NUSC_SAMPLE_AGGREGATE", False)) and group_size > 1

    def infer(images, intrinsics, pose_quat=None, pose_tvec=None):
        with annotate("serve"), torch.inference_mode(), quant_scope(spec):
            with annotate("serve.to_device"):
                images = torch.as_tensor(images, device=device)
                intrinsics = torch.as_tensor(intrinsics, device=device)
            with annotate("serve.forward"):
                outputs = model(images)
            with annotate("serve.decode"):
                det = dd3d_inference(cfg, outputs, intrinsics, model.strides, suppress=suppress, scan=scan)
            if aggregate and pose_quat is not None:
                g = group_size

                def regroup(x):
                    return x.reshape((-1, g) + tuple(x.shape[1:]))

                with annotate("serve.aggregate"):
                    out = sample_bev_nms_in_graph(
                        {k: regroup(v) for k, v in det.items()}, regroup(intrinsics),
                        regroup(torch.as_tensor(pose_quat, device=device)),
                        regroup(torch.as_tensor(pose_tvec, device=device)),
                        iou_threshold=cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH, max_dets=500, scan=scan)
                    det = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in out.items()}
            return det

    infer.quant = spec
    return infer


def unpack_detections(det: Dict[str, np.ndarray], batch: Dict[str, np.ndarray], meta: List[dict]) -> List[dict]:
    """Padded (B, D) detections -> one dict per image: 2D boxes rescaled from
    network-input resolution to the original image and clipped, 3D boxes as
    camera-frame (quat, tvec, size); attributes and speeds, and the sample
    aggregation's quat_global / tvec_global, where the detections hold them."""
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
        if "attributes" in det:
            item["attributes"] = det["attributes"][i][sel]
            item["speeds"] = det["speeds"][i][sel]
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
            if "quat_global" in det:  # the sample aggregation's global-frame boxes
                item["quat_global"] = det["quat_global"][i][sel]
                item["tvec_global"] = det["tvec_global"][i][sel]
        out.append(item)
    return out


def inference_on_dataset(model, cfg, dataloader, evaluators, visualize_dir=None, max_vis: int = 8, suppress=None,
                         group_size: int = 1):
    """Run the model over a test loader of (batch, meta), feed the
    evaluators, and return their merged results (cf. d2's
    inference_on_dataset as scripts/train.py:196 uses it). A producer
    thread runs the loader two batches ahead, so mapping overlaps the
    forward; an exception in the loader is raised here. `model` may be a
    DistributedDataParallel wrapper: its module runs. Each rank evaluates the
    batches of its own loader on its own card, then every rank joins
    `comm.raise_if_any_rank_failed` before the evaluators' `evaluate` (a
    gather): an error on one rank is raised on every rank. `suppress` and
    `group_size` are passed on to `get_inference_fn`: with the sample
    aggregation on, every batch must hold whole samples and their poses
    (pose_quat / pose_tvec, which the nuScenes mapper emits), else this
    raises (dd3d_tpu/models/postprocess.py:236-246).

    With `visualize_dir`, the first `max_vis` images of this loader get a
    prediction drawing, `<visualize_dir>/pred_<image_id>.png`: the network
    input (the resized image), its 2D boxes rescaled to it and its 3D
    wireframes, at score >= 0.3 (dd3d_tpu/models/postprocess.py:184-297,
    whose copy to W&B through `put_image` is not ported)."""
    error = None
    try:
        _process_dataset(model, cfg, dataloader, evaluators, visualize_dir, max_vis, suppress, group_size)
    except Exception as e:  # this rank's part failed: every rank learns it before the gather
        error = e
    comm.raise_if_any_rank_failed(error)
    results = {}
    for ev in evaluators:
        r = ev.evaluate()
        if r:
            results.update(r)
    return results


def _process_dataset(model, cfg, dataloader, evaluators, visualize_dir, max_vis, suppress, group_size):
    """This rank's part of `inference_on_dataset`: the forward of every
    batch of its loader into the evaluators' `process`, and the drawings."""
    infer = get_inference_fn(getattr(model, "module", model), cfg, suppress=suppress, group_size=group_size)
    aggregate = bool(cfg.DD3D.INFERENCE.get("NUSC_SAMPLE_AGGREGATE", False)) and group_size > 1
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
    n_vis = 0
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            batch, meta = item
            if aggregate:
                if batch["image"].shape[0] % group_size:
                    raise ValueError(f"Sample aggregation needs whole {group_size}-camera groups per batch; got "
                                     f"batch of {batch['image'].shape[0]}")
                if "pose_quat" not in batch:
                    raise KeyError("NUSC_SAMPLE_AGGREGATE requires camera poses in the batch (the nuScenes mapper "
                                   "emits them as pose_quat/pose_tvec).")
                det = infer(batch["image"], batch["intrinsics"], batch["pose_quat"], batch["pose_tvec"])
            else:
                det = infer(batch["image"], batch["intrinsics"])
            per_image = unpack_detections(det, batch, meta)
            for ev in evaluators:
                ev.process(per_image)
            if visualize_dir is not None and n_vis < max_vis:
                n_vis += visualize_predictions(batch, meta, per_image, visualize_dir, max_vis - n_vis)
    finally:
        stop.set()
        thread.join(timeout=5)


def visualize_predictions(batch, meta, per_image, visualize_dir: str, max_n: int) -> int:
    """Draw the detections of the first `max_n` images of a test batch on
    their network inputs (boxes kept at score >= 0.3, 2D boxes rescaled
    from the original resolution to the input's) and save them as
    `pred_<image_id>.png`; returns the number drawn."""
    from dd3d_tpu_torch.visualizers.draw import draw_boxes2d, draw_boxes3d, save_vis

    images = np.asarray(batch["image"])
    sizes = np.asarray(batch["image_size"])
    intrinsics = np.asarray(batch["intrinsics"])
    n = 0
    for i, d in enumerate(per_image[:max_n]):
        h, w = sizes[i]
        img = images[i, :h, :w].astype(np.uint8)
        sx = w / max(meta[i].get("width") or w, 1)
        sy = h / max(meta[i].get("height") or h, 1)
        keep = d["scores"] >= 0.3
        vis = draw_boxes2d(img, d["boxes2d"][keep] * [sx, sy, sx, sy], d["classes"][keep], d["scores"][keep])
        if "quat" in d:
            vis = draw_boxes3d(vis, d["quat"][keep], d["tvec"][keep], d["size"][keep], intrinsics[i],
                               d["classes"][keep])
        save_vis(vis, visualize_dir, f"pred_{d['image_id']}")
        n += 1
    return n
