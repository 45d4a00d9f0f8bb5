"""The plain rig reference: what DD3D's nuScenes serving returns for a
sample of cameras, worked out from the reference model's NCHW outputs.
Copied from tests/torch_ref_nusc.py (the 3D decode, the BEV boxes, the
rotated IoU, the walks, the global boxes), with the 2D candidates and NMS
of `reference.decode`; kept under benchmark/ so that a later change to the
test oracle cannot move the yardstick. Plain torch in f32 and numpy; the
rotated IoU in f64 on the host; imports nothing of the program.

- `boxes3d`: the 3D box of image b at (location, class) pairs of a level,
  as DD3D.FCOS3D states it: the quaternion normalized and turned from the
  viewing ray's frame into the camera's (PREDICT_ALLOCENTRIC_ROT), the
  projected centre (offset + location), the depth over the pixel size
  times the focal factor, clamped, the size (tanh + 1) times the class's
  canonical size; with the attribute argmax and the speed at the location.
- `bev_boxes`: a box's top face (object z = +h/2) in BEV, as tridet's
  `boxes3d_to_rotated_boxes` reads it: (cx, cy, w, l, angle), the centre
  the midpoint of the front-left / back-right diagonal, w and l the front
  and left edges, the angle the heading of the left edge.
- `rotated_iou`: the exact IoU of the rectangles those five numbers
  denote, in f64: the intersection is the convex hull of the corners of
  each rectangle inside the other and the crossings of their edges,
  ordered by angle about their mean, its area by the shoelace formula.
- `serve_sample`: a sample as the serving entry returns it: each image's
  2D detections (`reference.decode`) through the per-image BEV NMS in the
  camera's BEV, then each camera's boxes composed with its camera ->
  global pose and one class-aware BEV walk over the sample, at most
  SAMPLE_MAX_DETS kept in score order.

Departures from the description, each for a fixed-size program: the
top-k per level is the blocked one (USE_APPROX_TOPK, `reference.decode`);
rotations are carried as matrices (the served quaternions are compared
through their matrices, so a quaternion's sign never matters).
"""
from typing import Dict, List

import numpy as np
import torch

from reference import decode

CAMERA_TO_BEV = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])  # BEV x = camera x, y = -z
VEHICLE_TO_BEV = np.array([[0.0, -1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])
FIELDS = ("box", "score3d", "cls", "level", "loc", "depth", "attr", "speed", "rot", "tvec", "size")


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion, normalized here -> (..., 3, 3)."""
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [[w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rot_np(q) -> np.ndarray:
    return quat_to_rot(torch.as_tensor(np.asarray(q), dtype=torch.float64)).numpy()


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


def _channels(t: torch.Tensor, b: int, comps: int, loc: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """(n, comps) of an NCHW map whose channel comp * C + class holds a
    component of a class, at locations `loc` (row-major) and classes `cls`."""
    flat = t[b].float().reshape(comps, t.shape[1] // comps, -1)
    return flat[:, cls, loc].T


def boxes3d(outputs, b: int, level: int, loc: torch.Tensor, cls: torch.Tensor, stride: int,
            intrinsics: torch.Tensor, dec) -> Dict[str, torch.Tensor]:
    """Image b's 3D boxes at (location, class) pairs of one level: rot
    (n, 3, 3) camera frame, proj_ctr, depth, size (w, l, h), tvec; and the
    location's attribute argmax and speed."""
    w = outputs["logits"][level].shape[-1]
    xy = torch.stack([(loc % w).float() * stride, (loc // w).float() * stride], dim=-1)
    inv_k = torch.linalg.inv(intrinsics.double()).float()
    quat = _channels(outputs["quat"][level], b, 4, loc, cls)
    proj_ctr = _channels(outputs["proj_ctr"][level], b, 2, loc, cls) + xy
    depth = _channels(outputs["depth"][level], b, 1, loc, cls)[:, 0]
    if dec["SCALE_DEPTH_BY_FOCAL_LENGTHS"]:
        pixel = torch.sqrt(inv_k[0, 0] ** 2 + inv_k[1, 1] ** 2)
        depth = depth / torch.clamp(pixel * dec["SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR"], min=1e-7)
    depth = depth.clamp(dec["MIN_DEPTH"], dec["MAX_DEPTH"])
    canon = torch.as_tensor(dec["CANONICAL_BOX3D_SIZES"], dtype=torch.float32, device=loc.device)[cls]
    size = (torch.tanh(_channels(outputs["size"][level], b, 3, loc, cls)) + 1.0) * canon
    ray = torch.cat([proj_ctr, torch.ones_like(depth)[:, None]], dim=-1) @ inv_k.T
    rot = ray_frame(ray) @ quat_to_rot(quat)
    attr = outputs["attr_logits"][level][b].float()
    return {"rot": rot, "proj_ctr": proj_ctr, "depth": depth, "size": size, "tvec": ray * depth[:, None],
            "attr": attr.reshape(attr.shape[0], -1)[:, loc].argmax(dim=0),
            "speed": outputs["speed"][level][b].float().reshape(-1)[loc]}


def at(outputs, b: int, level: np.ndarray, loc: np.ndarray, cls: np.ndarray, intrinsics: torch.Tensor,
       dec) -> Dict[str, np.ndarray]:
    """`boxes3d` at (level, location, class) triples of image b, on the host
    in f64, in the order given."""
    n = len(level)
    out = {"rot": np.zeros((n, 3, 3)), "tvec": np.zeros((n, 3)), "size": np.zeros((n, 3)), "depth": np.zeros(n),
           "attr": np.zeros(n, np.int64), "speed": np.zeros(n)}
    device = outputs["logits"][0].device
    for l in np.unique(level) if n else []:
        sel = np.nonzero(level == l)[0]
        got = boxes3d(outputs, b, int(l), torch.as_tensor(loc[sel], device=device),
                      torch.as_tensor(cls[sel], device=device), dec["strides"][int(l)], intrinsics, dec)
        for k in out:
            out[k][sel] = got[k].detach().cpu().double().numpy()
    return out


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
    if len(size) == 0:
        return np.zeros((0, 5))
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
    a5, b5 = np.asarray(a5, np.float64).reshape(-1, 5), np.asarray(b5, np.float64).reshape(-1, 5)
    ra = np.hypot(a5[:, 2], a5[:, 3]) / 2
    rb = np.hypot(b5[:, 2], b5[:, 3]) / 2
    near = np.hypot(a5[:, None, 0] - b5[None, :, 0], a5[:, None, 1] - b5[None, :, 1]) <= ra[:, None] + rb[None, :]
    if pairs is not None:
        near &= pairs
    out = np.zeros((len(a5), len(b5)))
    i, j = np.nonzero(near)
    for start in range(0, len(i), 200_000):  # bounded host memory
        ii, jj = i[start:start + 200_000], j[start:start + 200_000]
        inter = _intersection(a5[ii], b5[jj])
        union = a5[ii, 2] * a5[ii, 3] + b5[jj, 2] * b5[jj, 3] - inter
        out[ii, jj] = inter / np.maximum(union, 1e-9)
    return out


def same_class_iou(box5: np.ndarray, cls: np.ndarray, among=None) -> np.ndarray:
    """(n, n) rotated IoU of boxes of one class (0 across classes); `among`
    (n,) bool limits it to the pairs of those boxes."""
    pairs = cls[:, None] == cls[None, :]
    if among is not None:
        pairs &= among[:, None] & among[None, :]
    return rotated_iou(box5, box5, pairs)


def walk(iou: np.ndarray, valid: np.ndarray, cls: np.ndarray, thresh: float, topk: int = 0) -> np.ndarray:
    """`reference.decode.greedy_walk` (class-aware, score order), no cap
    where `topk` is 0."""
    return decode.greedy_walk(iou, valid, cls, thresh, topk or len(valid) + 1)


def to_global(rot: np.ndarray, tvec: np.ndarray, pose_quat, pose_tvec):
    """(rot (n, 3, 3), tvec (n, 3)) of a camera's boxes in the global frame,
    the camera -> global pose given as a wxyz quaternion and a translation."""
    r = quat_to_rot_np(pose_quat)
    return r @ rot, tvec @ r.T + np.asarray(pose_tvec, np.float64)


def candidates(outputs, levels, intrinsics: torch.Tensor, dec) -> List[Dict[str, np.ndarray]]:
    """Per image of a block, `decode.nms`'s candidates (score order, the 2D
    NMS's `kept`, `iou`, `margin`) with every valid candidate's 3D box,
    attribute and speed (`at`)."""
    images = decode.nms(decode.candidates(levels, dec), dec)
    for b, image in enumerate(images):
        v = image["valid"]
        fields = at(outputs, b, image["level"][v], image["loc"][v], image["cls"][v], intrinsics[b], dec)
        for k, x in fields.items():
            full = np.zeros((len(v),) + x.shape[1:], x.dtype)
            full[v] = x
            image[k] = full  # `depth` as the dense decode gives it, the same value
    return images


def serve_sample(outputs, levels, intrinsics: torch.Tensor, pose_quat, pose_tvec, dec) -> List[Dict[str, np.ndarray]]:
    """One sample's served detections (a block of its cameras' outputs):
    per image, in score order, `FIELDS` plus `rot_g` / `tvec_g`, after the
    per-image BEV NMS and the sample walk."""
    t = dec["BEV_NMS_IOU_THRESH"]
    dets = []
    for b, image in enumerate(candidates(outputs, levels, intrinsics, dec)):
        det = {k: image[k][image["kept"]] for k in FIELDS}
        bev = bev_boxes(det["rot"], det["tvec"], det["size"], CAMERA_TO_BEV)
        keep = walk(same_class_iou(bev, det["cls"]), np.ones(len(bev), bool), det["cls"], t)
        det = {k: v[keep] for k, v in det.items()}
        det["rot_g"], det["tvec_g"] = to_global(det["rot"], det["tvec"], pose_quat[b], pose_tvec[b])
        dets.append(det)
    keep = sample_walk(dets, t, int(dec["SAMPLE_MAX_DETS"]))
    return [{k: v[m] for k, v in det.items()} for det, m in zip(dets, keep)]


def sample_order(dets: List[Dict[str, np.ndarray]]) -> np.ndarray:
    """(n, 2) (camera, index) of a sample's boxes in walk order: descending
    3D score, stable over the cameras' boxes laid end to end."""
    score = np.concatenate([d["score3d"] for d in dets])
    who = np.concatenate([np.stack([np.full(len(d["score3d"]), c), np.arange(len(d["score3d"]))], 1)
                          for c, d in enumerate(dets)]).reshape(-1, 2)
    return who[np.argsort(-score, kind="stable")]


def global_bev(dets: List[Dict[str, np.ndarray]], who: np.ndarray) -> np.ndarray:
    """(n, 5) the global BEV boxes of the (camera, index) pairs `who`."""
    if not len(who):
        return np.zeros((0, 5))
    rot, tvec, size = (np.stack([dets[c][k][i] for c, i in who]) for k in ("rot_g", "tvec_g", "size"))
    return bev_boxes(rot, tvec, size, VEHICLE_TO_BEV)


def sample_walk(dets: List[Dict[str, np.ndarray]], thresh: float, topk: int) -> List[np.ndarray]:
    """Keep masks per camera of one class-aware BEV walk over the sample's
    boxes in the global frame, at most `topk` kept."""
    who = sample_order(dets)
    cls = np.array([dets[c]["cls"][i] for c, i in who], np.int64)
    kept = walk(same_class_iou(global_bev(dets, who), cls), np.ones(len(who), bool), cls, thresh, topk)
    masks = [np.zeros(len(d["score3d"]), bool) for d in dets]
    for (c, i), k in zip(who, kept):
        masks[c][i] = k
    return masks
