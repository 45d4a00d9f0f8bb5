"""Plain reference of DD3D's nuScenes serving, for the port's tests: the
NuscenesDD3D graph on DLA-34 and what its serving returns, worked out from
the published description (TRI-ML/dd3d `dd3d_nusc_dla34.yaml`,
`nuscenes_dd3d.py`, `fcos2d.py` / `fcos3d.py`'s inference,
`postprocessing.py`'s sample aggregation, `layers/bev_nms.py`).

Plain torch in f32 (TF32 is the caller's to turn off) and numpy; the
rotated IoU in f64 on the host. It imports the frozen `torch_ref_dd3d.py`
and nothing of the port or of JAX.

- `TorchNuscenesDD3D`: `TorchDD3D` plus the 4 attribute logits and the
  ReLU'd speed, 3x3 convs on each level's cls-tower output, at the root as
  the reference names them (`attr_logits.*`, `speed.*`).
- `decode_image`: one image's detections. Per level the FCOS2D candidates
  (sqrt(sigmoid(logit) * sigmoid(centerness)) above PRE_NMS_THRESH on the
  product, the blocked top-k), each decoded at its (location, class): the
  quaternion normalized and turned from the viewing ray's frame into the
  camera's (PREDICT_ALLOCENTRIC_ROT), the projected centre (offset +
  location), the depth over the pixel size times 500 clamped to [0.1, 80],
  the size (tanh + 1) times the class's canonical size, the 3D score, the
  attribute argmax and the speed; the NMS_CANDIDATES best 3D scores of all
  levels, a class-aware greedy 2D NMS at NMS_THRESH, POST_NMS_TOPK kept.
- `bev_boxes`: a box's top face (object z = +h/2) in BEV, as tridet's
  `boxes3d_to_rotated_boxes` reads it: (cx, cy, w, l, angle) with the
  centre the midpoint of the front-left / back-right diagonal, w and l the
  front and left edges, the angle the heading of the left edge.
- `rotated_iou`: the exact IoU of the rectangles those five numbers denote,
  in f64: the intersection is the convex hull of the corners of each
  rectangle inside the other and the crossings of their edges, ordered by
  angle about their mean, its area by the shoelace formula.
- `greedy_walk`: class-aware greedy suppression at IoU > threshold, in
  score order, at most `topk` kept.
- `serve_sample`: a sample of cameras as the serving entry returns it: each
  image's detections through the per-image BEV NMS (the camera's BEV), then
  each camera's boxes composed with its pose into the global frame and one
  class-aware BEV walk over the sample, at most 500 kept in score order.

Departures from the description, each for a fixed-size program: the
top-k per level is the port's blocked one (USE_APPROX_TOPK); rotations are
carried as matrices (compared with the served quaternions through their
matrices, so a quaternion's sign never matters).
"""
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tests.torch_ref_dd3d import TorchDD3D

NEG = -1e9
NUSC_MEAN_DEPTH = (44.921, 20.252, 11.712, 7.166, 8.548)
NUSC_STD_DEPTH = (24.331, 9.833, 6.223, 4.611, 8.275)
CAMERA_TO_BEV = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])  # BEV x = camera x, y = -z
VEHICLE_TO_BEV = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
SAMPLE_MAX = 500


class TorchNuscenesDD3D(TorchDD3D):
    """Reference-named NuscenesDD3D on DLA-34 + FPN P3-P7."""

    def __init__(self, num_classes=10, mean_depth=NUSC_MEAN_DEPTH, std_depth=NUSC_STD_DEPTH, max_attr=4):
        super().__init__(num_classes=num_classes, mean_depth=mean_depth, std_depth=std_depth)
        self.attr_logits = nn.Conv2d(256, max_attr, 3, 1, 1)
        self.speed = nn.Conv2d(256, 1, 3, 1, 1)

    def forward(self, images_nchw):
        x = (images_nchw - self.pixel_mean) / self.pixel_std
        feats = self.backbone(x)
        features = [feats[f] for f in ("p3", "p4", "p5", "p6", "p7")]
        logits, box2d, ctr, towers = self.fcos2d_head(features)
        quat, pctr, depth, size, conf = self.fcos3d_head(features)
        return {
            "logits": logits, "box2d_reg": box2d, "centerness": ctr,
            "quat": quat, "proj_ctr": pctr, "depth": depth, "size": size, "conf": conf,
            "attr_logits": [self.attr_logits(c) for c in towers],
            "speed": [F.relu(self.speed(c)) for c in towers],
        }


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion, normalized here -> (..., 3, 3)."""
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [[w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def ray_frame(ray: torch.Tensor) -> torch.Tensor:
    """(..., 3) viewing rays -> (..., 3, 3) the rotation from the ray's frame
    (z along the ray, y the camera's y made orthogonal to it) to the camera's."""
    z = ray / ray.norm(dim=-1, keepdim=True)
    y = torch.zeros_like(z)
    y[..., 1] = 1.0
    y = y - z[..., 1:2] * z
    y = y / y.norm(dim=-1, keepdim=True)
    x = torch.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def _channels(t: torch.Tensor, b: int, comps: int, loc: torch.Tensor, cls: torch.Tensor, nc: int) -> torch.Tensor:
    """(n, comps) of an NCHW map whose channel comp * nc + class holds a
    component of a class, at locations `loc` (row-major) and classes `cls`."""
    flat = t[b].float().reshape(comps, nc, -1)
    return flat[:, cls, loc].T


def boxes3d(outputs, b: int, level: int, loc: torch.Tensor, cls: torch.Tensor, stride: int,
            intrinsics: torch.Tensor, dec) -> Dict[str, torch.Tensor]:
    """The 3D box of image `b` at (location, class) pairs of one level:
    rot (n, 3, 3) camera frame, proj_ctr (n, 2), depth (n,), size (n, 3)
    (w, l, h), tvec (n, 3), conf (n,)."""
    nc = dec["num_classes"]
    w = outputs["logits"][level].shape[-1]
    xy = torch.stack([(loc % w).float() * stride, (loc // w).float() * stride], dim=-1)
    inv_k = torch.linalg.inv(intrinsics.double()).float()
    quat = _channels(outputs["quat"][level], b, 4, loc, cls, nc)
    proj_ctr = _channels(outputs["proj_ctr"][level], b, 2, loc, cls, nc) + xy
    pixel = torch.sqrt(inv_k[0, 0] ** 2 + inv_k[1, 1] ** 2)
    depth = _channels(outputs["depth"][level], b, 1, loc, cls, nc)[:, 0] / torch.clamp(pixel * 500.0, min=1e-7)
    depth = depth.clamp(dec["MIN_DEPTH"], dec["MAX_DEPTH"])
    canon = torch.as_tensor(dec["CANONICAL_BOX3D_SIZES"], dtype=torch.float32, device=loc.device)[cls]
    size = (torch.tanh(_channels(outputs["size"][level], b, 3, loc, cls, nc)) + 1.0) * canon
    ray = torch.cat([proj_ctr, torch.ones_like(depth)[:, None]], dim=-1) @ inv_k.T
    rot = ray_frame(ray) @ quat_to_rot(quat)
    conf = torch.sigmoid(_channels(outputs["conf"][level], b, 1, loc, cls, nc)[:, 0])
    return {"rot": rot, "proj_ctr": proj_ctr, "depth": depth, "size": size, "tvec": ray * depth[:, None],
            "conf": conf}


def _blocked_topk(flat: torch.Tensor, k: int):
    """(values, indices) of the k best of `flat` (n,): the best of each run
    of n // (6k) entries (the first on ties), then the k best runs, ties to
    the lower index."""
    n = flat.shape[0]
    k = min(k, n)
    if k < n:
        block = max(1, n // (6 * k))
        nb = -(-n // block)
        runs = F.pad(flat, (0, nb * block - n), value=NEG).reshape(nb, block)
        best, arg = runs.max(dim=1)
        vals, order = torch.sort(best, descending=True, stable=True)
        return vals[:k], torch.clamp(order[:k] * block + arg[order[:k]], max=n - 1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) IoU of xyxy boxes."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(dim=-1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(dim=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter).clamp(min=1e-9)


def greedy_walk(iou: np.ndarray, cls: np.ndarray, thresh: float, topk: int = 0, valid=None) -> np.ndarray:
    """Keep mask of candidates in score order: each is kept unless a kept
    candidate of its class before it overlaps it at IoU > `thresh`; with
    `topk` > 0 at most that many kept."""
    n = len(cls)
    alive = np.ones(n, bool) if valid is None else np.asarray(valid, bool).copy()
    kept = np.zeros(n, bool)
    for j in range(n):
        if not alive[j]:
            continue
        kept[j] = True
        if topk and kept.sum() == topk:
            break
        alive[j + 1:] &= ~((iou[j, j + 1:] > thresh) & (cls[j + 1:] == cls[j]))
    return kept


def decode_image(outputs, b: int, intrinsics: torch.Tensor, dec) -> Dict[str, torch.Tensor]:
    """Image `b`'s served detections before the BEV NMS, in descending 3D
    score order: box (n, 4), score, score3d, cls, level, loc, attr, speed
    and `boxes3d`'s fields."""
    parts = []
    for level, stride in enumerate(dec["strides"]):
        logits = outputs["logits"][level][b].float()
        nc, h, w = logits.shape
        cls_p = torch.sigmoid(logits).reshape(nc, -1).T  # (HW, C)
        ctr = torch.sigmoid(outputs["centerness"][level][b].float()).reshape(-1, 1)
        combined = cls_p * ctr
        flat = torch.where(combined > dec["PRE_NMS_THRESH"], combined, torch.full_like(combined, NEG)).reshape(-1)
        vals, idx = _blocked_topk(flat, dec["PRE_NMS_CANDIDATES_PER_LEVEL"])
        keep = vals > NEG / 2
        vals, idx = vals[keep], idx[keep]
        loc, cls = idx // nc, idx % nc
        reg = outputs["box2d_reg"][level][b].float().reshape(4, -1)[:, loc].T
        xy = torch.stack([(loc % w).float() * stride, (loc // w).float() * stride], dim=-1)
        box3d = boxes3d(outputs, b, level, loc, cls, stride, intrinsics, dec)
        score = torch.sqrt(vals)
        attr = outputs["attr_logits"][level][b].float().reshape(outputs["attr_logits"][level].shape[1], -1)
        parts.append({"box": torch.cat([xy - reg[:, :2], xy + reg[:, 2:]], dim=-1), "score": score,
                      "score3d": score * box3d.pop("conf"), "cls": cls, "level": torch.full_like(cls, level),
                      "loc": loc, "attr": attr[:, loc].argmax(dim=0),
                      "speed": outputs["speed"][level][b].float().reshape(-1)[loc], **box3d})
    cand = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    order = torch.sort(cand["score3d"], descending=True, stable=True).indices[:dec["NMS_CANDIDATES"]]
    cand = {k: v[order] for k, v in cand.items()}
    iou = box_iou(cand["box"], cand["box"]).double().cpu().numpy()
    kept = greedy_walk(iou, cand["cls"].cpu().numpy(), dec["NMS_THRESH"], dec["POST_NMS_TOPK"])
    kept = torch.as_tensor(kept, device=cand["box"].device)
    return {k: v[kept] for k, v in cand.items()}


def top_face(rot: np.ndarray, tvec: np.ndarray, size: np.ndarray) -> np.ndarray:
    """(n, 4, 3) front-left, front-right, back-right, back-left corners of
    each box's top face (object x along the length, y the width, z the
    height; size is (w, l, h))."""
    w, l, h = size[:, 0], size[:, 1], size[:, 2]
    signs = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float64)
    local = np.stack([0.5 * l[:, None] * signs[:, 0], 0.5 * w[:, None] * signs[:, 1],
                      np.broadcast_to(0.5 * h[:, None], (len(w), 4))], axis=-1)
    return np.einsum("nij,nkj->nki", rot, local) + tvec[:, None, :]


def bev_boxes(rot: np.ndarray, tvec: np.ndarray, size: np.ndarray, to_bev: np.ndarray) -> np.ndarray:
    """(n, 5) (cx, cy, w, l, angle in degrees) of each box's top face in the
    BEV plane that `to_bev` rotates the frame onto."""
    fl, fr, br, bl = np.moveaxis((top_face(rot, tvec, size) @ to_bev.T)[..., :2], 1, 0)
    fwd = fl - bl
    return np.stack([(fl[:, 0] + br[:, 0]) / 2, (fl[:, 1] + br[:, 1]) / 2, np.linalg.norm(fl - fr, axis=-1),
                     np.linalg.norm(fwd, axis=-1), np.degrees(np.arctan2(fwd[:, 0], fwd[:, 1]))], axis=-1)


def rect_corners(box5: np.ndarray) -> np.ndarray:
    """(n, 4, 2) corners of the rectangles (cx, cy, w, l, angle): the length
    along (sin a, cos a), the width along (cos a, -sin a)."""
    a = np.radians(box5[:, 4])
    u = np.stack([np.sin(a), np.cos(a)], axis=-1) * box5[:, 3:4] / 2
    v = np.stack([np.cos(a), -np.sin(a)], axis=-1) * box5[:, 2:3] / 2
    c = box5[:, None, :2]
    return np.stack([c[:, 0] + u + v, c[:, 0] + u - v, c[:, 0] - u - v, c[:, 0] - u + v], axis=1)


def _inside(points: np.ndarray, box5: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """(p, k) whether each of k points (p, k, 2) lies in its pair's rectangle (p, 5)."""
    a = np.radians(box5[:, 4])
    d = points - box5[:, None, :2]
    along = d[..., 0] * np.sin(a)[:, None] + d[..., 1] * np.cos(a)[:, None]
    across = d[..., 0] * np.cos(a)[:, None] - d[..., 1] * np.sin(a)[:, None]
    return (np.abs(along) <= box5[:, None, 3] / 2 + eps) & (np.abs(across) <= box5[:, None, 2] / 2 + eps)


def _intersection(a5: np.ndarray, b5: np.ndarray) -> np.ndarray:
    """Intersection areas of rectangle pairs a5[i], b5[i] (p, 5)."""
    ca, cb = rect_corners(a5), rect_corners(b5)
    p0, d0 = ca[:, :, None], (np.roll(ca, -1, axis=1) - ca)[:, :, None]  # edges of a, (p, 4, 1, 2)
    p1, d1 = cb[:, None], (np.roll(cb, -1, axis=1) - cb)[:, None]  # edges of b, (p, 1, 4, 2)
    cross = lambda x, y: x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]  # noqa: E731
    den = cross(d0, d1)
    ok = np.abs(den) > 1e-12
    safe = np.where(ok, den, 1.0)
    t = cross(p1 - p0, d1) / safe
    s = cross(p1 - p0, d0) / safe
    hit = ok & (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
    crossings = (p0 + t[..., None] * d0).reshape(len(a5), 16, 2)
    pts = np.concatenate([ca, cb, crossings], axis=1)  # (p, 24, 2)
    use = np.concatenate([_inside(ca, b5), _inside(cb, a5), hit.reshape(len(a5), 16)], axis=1)
    n = use.sum(axis=1)
    centre = (pts * use[..., None]).sum(axis=1) / np.maximum(n, 1)[:, None]
    angle = np.where(use, np.arctan2(pts[..., 1] - centre[:, None, 1], pts[..., 0] - centre[:, None, 0]), np.inf)
    order = np.argsort(angle, axis=1, kind="stable")
    ring = np.take_along_axis(pts, order[..., None], axis=1)
    ring = np.where(np.take_along_axis(use, order, axis=1)[..., None], ring, ring[:, :1])  # unused: the first point
    area = 0.5 * np.abs(cross(ring, np.roll(ring, -1, axis=1)).sum(axis=1))
    return np.where(n >= 3, area, 0.0)


def rotated_iou(a5: np.ndarray, b5: np.ndarray, pairs=None) -> np.ndarray:
    """(n, m) IoU of rotated rectangles a5 (n, 5) and b5 (m, 5) in f64;
    `pairs` (n, m) bool limits the work to those pairs (0 elsewhere)."""
    a5, b5 = np.asarray(a5, np.float64), np.asarray(b5, np.float64)
    ra = np.hypot(a5[:, 2], a5[:, 3]) / 2
    rb = np.hypot(b5[:, 2], b5[:, 3]) / 2
    near = np.hypot(a5[:, None, 0] - b5[None, :, 0], a5[:, None, 1] - b5[None, :, 1]) <= ra[:, None] + rb[None, :]
    if pairs is not None:
        near &= pairs
    out = np.zeros((len(a5), len(b5)))
    i, j = np.nonzero(near)
    if len(i):
        inter = _intersection(a5[i], b5[j])
        union = a5[i, 2] * a5[i, 3] + b5[j, 2] * b5[j, 3] - inter
        out[i, j] = inter / np.maximum(union, 1e-9)
    return out


def same_class_iou(box5: np.ndarray, cls: np.ndarray) -> np.ndarray:
    return rotated_iou(box5, box5, cls[:, None] == cls[None, :])


def _host(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().double().numpy() if v.is_floating_point() else v.cpu().numpy() for k, v in det.items()}


def image_bev_nms(det: Dict[str, np.ndarray], thresh: float) -> np.ndarray:
    """Keep mask of one image's detections (host, score order) under the
    per-image BEV NMS in the camera's BEV."""
    bev = bev_boxes(det["rot"], det["tvec"], det["size"], CAMERA_TO_BEV)
    return greedy_walk(same_class_iou(bev, det["cls"]), det["cls"], thresh)


def to_global(det: Dict[str, np.ndarray], pose_quat: np.ndarray, pose_tvec: np.ndarray):
    """(rot (n, 3, 3), tvec (n, 3)) of a camera's boxes in the global frame,
    the camera -> global pose given as a wxyz quaternion and a translation."""
    r = quat_to_rot(torch.as_tensor(pose_quat, dtype=torch.float64)).numpy()
    return r @ det["rot"], det["tvec"] @ r.T + pose_tvec


def sample_walk(dets: List[Dict[str, np.ndarray]], thresh: float, topk: int = SAMPLE_MAX):
    """One class-aware BEV walk over a sample's cameras' boxes, each with
    `rot_g` / `tvec_g`: (kept masks per camera, the sample's candidates in
    walk order as (camera, index) pairs, the IoU matrix in that order)."""
    score = np.concatenate([d["score3d"] for d in dets])
    order = np.argsort(-score, kind="stable")
    who = np.concatenate([np.stack([np.full(len(d["cls"]), c), np.arange(len(d["cls"]))], 1) for c, d in
                          enumerate(dets)])[order]
    cat = {k: np.concatenate([d[k] for d in dets])[order] for k in ("rot_g", "tvec_g", "size", "cls")}
    iou = same_class_iou(bev_boxes(cat["rot_g"], cat["tvec_g"], cat["size"], VEHICLE_TO_BEV), cat["cls"])
    kept = greedy_walk(iou, cat["cls"], thresh, topk)
    masks = [np.zeros(len(d["cls"]), bool) for d in dets]
    for (c, i), k in zip(who, kept):
        masks[c][i] = k
    return masks, who, iou


def serve_sample(outputs, first: int, cameras: int, intrinsics, pose_quat, pose_tvec, dec) -> List[Dict]:
    """The served detections of images first .. first + cameras - 1, one
    sample: each image's, after its BEV NMS, in score order (host, f64),
    with `rot_g` / `tvec_g` and `kept`, the sample walk's mask."""
    dets = []
    for c in range(cameras):
        b = first + c
        det = _host(decode_image(outputs, b, intrinsics[b], dec))
        det = {k: v[image_bev_nms(det, dec["BEV_NMS_IOU_THRESH"])] for k, v in det.items()}
        det["rot_g"], det["tvec_g"] = to_global(det, np.asarray(pose_quat[b], np.float64),
                                                np.asarray(pose_tvec[b], np.float64))
        dets.append(det)
    masks, _, _ = sample_walk(dets, dec["BEV_NMS_IOU_THRESH"])
    for det, m in zip(dets, masks):
        det["kept"] = m
    return dets
