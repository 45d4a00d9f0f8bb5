"""The plain decode of DD3D's head outputs, and the plain class-aware greedy
NMS: what the served detections should be, worked out from the reference
model's NCHW outputs.

It follows the semantics the configuration states (its "decode" block):
FCOS2D scores sqrt(sigmoid(logit) * sigmoid(centerness)), candidates above
PRE_NMS_THRESH, PRE_NMS_CANDIDATES_PER_LEVEL of them a level taken by the
blocked top-k (USE_APPROX_TOPK: the best entry of each run of
n // (6 k) consecutive (location, class) entries, then the k best runs),
the 3D score as the 2D score times sigmoid(conf), the depth scaled by the
focal length and clamped, the NMS_CANDIDATES best 3D scores of all levels,
then a greedy NMS within each class at NMS_THRESH, keeping POST_NMS_TOPK.

Each candidate also carries `margin`: how far, in score units, its
selection lies from going the other way (the threshold, the runner-up of
its run, the first run not taken, the NMS_CANDIDATES cut), which the
kept-set comparison (reference/compare.py) needs to tell a decision that
rounding may flip from one it may not.
Plain PyTorch and NumPy; imports nothing of the program.
"""
from typing import Dict, List

import numpy as np
import torch

NEG_INF = -1e9


def locations(h: int, w: int, stride: int, device) -> torch.Tensor:
    """(h * w, 2) (x, y) of each feature cell, row-major, no half-stride shift."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) * stride,
                            torch.arange(w, device=device, dtype=torch.float32) * stride, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)


def dense_levels(outputs: Dict[str, List[torch.Tensor]], intrinsics: torch.Tensor, strides, dec) -> List[dict]:
    """Per level, every location's decoded fields, (B, HW[, C]) in f32:
    `box` (B, HW, 4), `score` and `score3d` and `depth` (B, HW, C), and the
    pre-sqrt `combined` the candidate selection ranks, and `cls`, the class
    probability alone."""
    inv_k = torch.linalg.inv(intrinsics.double()).float()
    pixel_size = torch.sqrt(inv_k[:, 0, 0] ** 2 + inv_k[:, 1, 1] ** 2)  # (B,)
    out = []
    for l, stride in enumerate(strides):
        logits = outputs["logits"][l].float()
        b, c, h, w = logits.shape
        flat = lambda x: x.float().permute(0, 2, 3, 1).reshape(b, h * w, -1)  # noqa: E731
        cls = torch.sigmoid(flat(logits))
        ctr = torch.sigmoid(flat(outputs["centerness"][l]))
        combined = cls * ctr
        reg = flat(outputs["box2d_reg"][l])
        loc = locations(h, w, stride, logits.device)[None]
        box = torch.cat([loc - reg[..., :2], loc + reg[..., 2:]], dim=-1)
        score = torch.sqrt(combined)
        conf = torch.sigmoid(flat(outputs["conf"][l]))
        depth = flat(outputs["depth"][l])
        if dec["SCALE_DEPTH_BY_FOCAL_LENGTHS"]:
            scale = torch.clamp(pixel_size * dec["SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR"], min=1e-7)
            depth = depth / scale[:, None, None]
        depth = torch.clamp(depth, dec["MIN_DEPTH"], dec["MAX_DEPTH"])
        out.append({"box": box, "score": score, "score3d": score * conf, "depth": depth, "combined": combined,
                    "cls": cls, "stride": stride})
    return out


def _root(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def _blocked_topk(flat: torch.Tensor, k: int, approx: bool):
    """(values, indices, margins) of the k best entries of each row; with
    `approx`, the best of each run of n // (6 k) entries (the first on
    ties), then the k best runs. Ties go to the lower index, as a stable
    sort gives. A margin is the least gap, in square-root units (the 2D
    score's), to the runner-up of the entry's run and to the best entry
    not taken."""
    b, n = flat.shape
    k = min(k, n)
    if approx and k < n:
        block = max(1, n // (6 * k))
        nb = -(-n // block)
        padded = torch.nn.functional.pad(flat, (0, nb * block - n), value=NEG_INF).reshape(b, nb, block)
        two = torch.topk(padded, min(2, block), dim=-1)
        bm, am = padded.max(dim=-1)
        runner = two.values[..., 1] if block > 1 else torch.full_like(bm, NEG_INF)
        vals, bidx = torch.sort(bm, dim=1, descending=True, stable=True)
        beyond = vals[:, k:k + 1] if k < nb else torch.full_like(vals[:, :1], NEG_INF)
        vals, bidx = vals[:, :k], bidx[:, :k]
        idx = torch.clamp(bidx * block + torch.gather(am, 1, bidx), max=n - 1)
        margin = torch.minimum(_root(vals) - _root(torch.gather(runner, 1, bidx)), _root(vals) - _root(beyond))
        return vals, idx, margin
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    beyond = vals[:, k:k + 1] if k < n else torch.full_like(vals[:, :1], NEG_INF)
    return vals[:, :k], idx[:, :k], _root(vals[:, :k]) - _root(beyond)


def candidates(levels: List[dict], dec) -> Dict[str, torch.Tensor]:
    """The NMS's input, (B, N): every level's selected candidates, then the
    NMS_CANDIDATES best by 3D score (stable), each with its location `loc`
    on its level and its selection `margin`."""
    parts = []
    for l, lv in enumerate(levels):
        b, hw, c = lv["score"].shape
        ranked = lv["combined"] if dec["THRESH_WITH_CTR"] else lv["cls"]
        mask = ranked > dec["PRE_NMS_THRESH"]
        flat = torch.where(mask, lv["combined"], torch.full_like(lv["combined"], NEG_INF)).reshape(b, hw * c)
        vals, idx, margin = _blocked_topk(flat, dec["PRE_NMS_CANDIDATES_PER_LEVEL"], dec["USE_APPROX_TOPK"])
        valid = vals > NEG_INF / 2
        over = _root(torch.gather(ranked.reshape(b, hw * c), 1, idx)) - dec["PRE_NMS_THRESH"] ** 0.5
        margin = torch.minimum(margin, over)
        loc, cls = idx // c, idx % c
        score = torch.where(valid, torch.sqrt(torch.clamp(vals, min=0.0)), torch.full_like(vals, NEG_INF))
        s3 = torch.gather(lv["score3d"].reshape(b, hw * c), 1, idx)
        parts.append({
            "box": torch.gather(lv["box"], 1, loc[..., None].expand(b, loc.shape[1], 4)),
            "score": score, "score3d": torch.where(valid, s3, score), "cls": cls, "valid": valid,
            "level": torch.full_like(cls, l), "depth": torch.gather(lv["depth"].reshape(b, hw * c), 1, idx),
            "loc": loc, "margin": margin,
        })
    merged = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
    cap = int(dec["NMS_CANDIDATES"])
    if 0 < cap < merged["score3d"].shape[1]:
        ranked, top = torch.sort(merged["score3d"], dim=1, descending=True, stable=True)
        top = top[:, :cap]
        merged = {k: torch.gather(v, 1, top if v.dim() == 2 else top[..., None].expand(-1, -1, v.shape[-1]))
                  for k, v in merged.items()}
        merged["margin"] = torch.minimum(merged["margin"], merged["score3d"] - ranked[:, cap:cap + 1])
    return merged


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) IoU of xyxy boxes."""
    area = lambda x: (x[..., 2] - x[..., 0]).clamp(min=0) * (x[..., 3] - x[..., 1]).clamp(min=0)  # noqa: E731
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter).clamp(min=1e-9)


def greedy_walk(iou: np.ndarray, valid: np.ndarray, cls: np.ndarray, thresh: float, topk: int,
                across_classes: bool = False) -> np.ndarray:
    """The keep mask of candidates in score order: a box is suppressed by
    any kept box of its class (of any class, `across_classes`) that
    precedes it with IoU > `thresh`; at most `topk` kept."""
    alive, kept = valid.copy(), np.zeros(len(valid), bool)
    for j in range(len(alive)):
        if not alive[j]:
            continue
        kept[j] = True
        if kept.sum() == topk:
            break
        alive[j + 1:] &= ~((iou[j, j + 1:] > thresh) & ((cls[j + 1:] == cls[j]) | across_classes))
    return kept


def nms(cand: Dict[str, torch.Tensor], dec) -> List[Dict[str, np.ndarray]]:
    """Per image, the candidates in descending 3D score order (stable), on
    the host, with `iou` (N, N) and the greedy NMS's `kept` mask."""
    order = torch.sort(cand["score3d"], dim=1, descending=True, stable=True).indices
    sorted_ = {k: torch.gather(v, 1, order if v.dim() == 2 else order[..., None].expand(-1, -1, v.shape[-1]))
               for k, v in cand.items()}
    iou = iou_matrix(sorted_["box"], sorted_["box"]).cpu().numpy()
    host = {k: v.cpu().numpy() for k, v in sorted_.items()}
    out = []
    for i in range(iou.shape[0]):
        image = {k: v[i] for k, v in host.items()}
        image["iou"] = iou[i]
        image["kept"] = greedy_walk(iou[i], image["valid"], image["cls"], dec["NMS_THRESH"], dec["POST_NMS_TOPK"])
        out.append(image)
    return out


def kept(image: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The kept detections of one image of `nms`, in score order."""
    return {k: v[image["kept"]] for k, v in image.items() if k not in ("iou", "kept", "valid")}


def detections(levels: List[dict], dec) -> List[Dict[str, np.ndarray]]:
    """The served detections as the reference works them out."""
    return [kept(image) for image in nms(candidates(levels, dec), dec)]
