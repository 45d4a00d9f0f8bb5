"""The comparison that decides `correct` for a rig of cameras served with
the sample aggregation: a sample's served detections against the plain
reference (`reference.rig`) of the same frames, intrinsics and poses.

Per image, as `reference.compare` judges a served detector: each served
detection matched to the location of its level that explains it best (the
reference's 2D box and 3D score of its class); `det_gap`, `det_mean` and
`depth_gap` as `compare.image_gaps` reads them against the reference's
final detections. At the matched location besides:
- `attr_mismatch`: the share of the image's detections whose attribute is
  not the reference's argmax there;
- `speed_gap`: the mean of |served speed - the reference's| / (1 + the
  reference's).

Per sample, the decisions of the two BEV walks (the per-image one in each
camera's BEV, the global one over the sample), read on the reference's
candidates (`decode.nms`'s, in score order, with their 3D boxes). A
decision is firm where neither rounding of the stated size nor an
uncertain decision upstream can flip it. A candidate is firmly present at
a walk where every decision before it firmly kept it (the 2D NMS's as
`compare.firm` reads it); firmly gone where a decision before it, or this
walk, firmly removed it. A pair's BEV IoU margin is the stated one plus
`yardstick_iou_scale` times the gap between the pair's IoU in the
yardstick's own geometry (its boxes at the same candidates) and the
reference's: how far the stated precision itself moves that overlap, which
a fixed margin cannot know (a few centimetres move a pedestrian's IoU by
more than 0.03). At each walk, in score order, a candidate is firmly kept
where it is firmly present, kept, and no candidate of its class that is not
firmly gone overlaps it past the threshold less the pair's margin while
lying ahead of it or within the score margin of its score (at the global
walk also: the candidates not firmly gone ahead of it are fewer than the
cap); firmly suppressed where a firmly kept candidate of its class, ahead
by more than the score margin, overlaps it past the threshold plus the
pair's margin. Numbers a sample:
- `sample_kept_missed`: the share of the candidates firmly kept by both
  walks that no served detection stands for;
- `sample_suppressed_served`: the share of the candidates firmly
  suppressed by a BEV walk that a served detection stands for; each share
  over at least `least_decisions` an image;
- `sample_overlap`: the largest global BEV IoU of two served detections of
  one class (against the same of the reference's survivors:
  `sample_overlap_gap`);
- `count_gap`: |served count - the reference's| over the reference's;
- `global_gap`: the mean over the served detections of the larger of the
  largest gap between their global rotation matrix and the reference's at
  the matched location, and the global centre's gap over 1 m plus the
  reference's depth.
Plain torch and numpy; imports nothing of the program.
"""
from typing import Dict, List

import numpy as np
import torch

from reference import compare, rig

IMAGE = ("det_gap", "det_mean", "depth_gap", "attr_mismatch", "speed_gap")
SAMPLE = ("count_gap", "global_gap")
COUNTS = ("n_firm_kept", "n_missed", "n_firm_suppressed", "n_suppressed_served")


def served_images(det: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """A served sample's (C, D, ...) arrays -> per image, its valid
    detections: `compare.served_images`'s fields, attr, speed, size and the
    global rotation and centre (`rot_g`, `tvec_g`)."""
    out = compare.served_images(det)
    for i, image in enumerate(out):
        sel = np.nonzero(det["valid"][i])[0]
        image.update(attr=det["attributes"][i][sel].astype(np.int64), speed=det["speeds"][i][sel].astype(np.float64),
                     size=det["boxes3d_size"][i][sel].astype(np.float64),
                     rot_g=rig.quat_to_rot_np(det["quat_global"][i][sel].reshape(-1, 4)),
                     tvec_g=det["tvec_global"][i][sel].astype(np.float64).reshape(-1, 3))
    return out


def staged(iou: np.ndarray, cls: np.ndarray, score: np.ndarray, present: np.ndarray, gone: np.ndarray,
           kept: np.ndarray, t: float, score_margin: float, im: np.ndarray, cap: int = 0):
    """(firmly kept, firmly suppressed) of one walk over candidates in its
    order, `im` each pair's (n, n) IoU margin; see the module docstring."""
    n = len(cls)
    gone = gone.copy()
    firm_kept, firm_out = np.zeros(n, bool), np.zeros(n, bool)
    same = cls[:, None] == cls[None, :]
    for i in range(n):
        ahead = np.arange(n) < i
        over = same[:, i] & (iou[:, i] > t - im[:, i])
        over[i] = False
        threat = over & ~gone & (ahead | (np.abs(score - score[i]) < score_margin))
        within_cap = not cap or int((ahead & ~gone).sum()) < cap
        firm_kept[i] = present[i] and kept[i] and within_cap and not threat.any()
        if (ahead & firm_kept & same[:, i] & (iou[:, i] > t + im[:, i]) & (score > score[i] + score_margin)).any():
            firm_out[i] = gone[i] = True
    return firm_kept, firm_out


def geometry(outputs, images: List[Dict[str, np.ndarray]], intrinsics: torch.Tensor, pose_quat, pose_tvec,
             dec) -> List[Dict[str, np.ndarray]]:
    """Per image, the 3D boxes that `outputs` (the yardstick's) give at the
    valid candidates of `images` (the reference's, `rig.candidates`): rot,
    tvec, size, and `rot_g` / `tvec_g` in the global frame; zeros elsewhere."""
    out = []
    for b, image in enumerate(images):
        v = image["valid"]
        got = rig.at(outputs, b, image["level"][v], image["loc"][v], image["cls"][v], intrinsics[b], dec)
        full = {}
        for k in ("rot", "tvec", "size"):
            full[k] = np.zeros((len(v),) + got[k].shape[1:])
            full[k][v] = got[k]
        full["rot_g"], full["tvec_g"] = rig.to_global(full["rot"], full["tvec"], pose_quat[b], pose_tvec[b])
        out.append(full)
    return out


def pair_margins(iou: np.ndarray, iou_yard: np.ndarray, margins) -> np.ndarray:
    """Each pair's BEV IoU margin: the stated one plus `yardstick_iou_scale`
    times |the yardstick's IoU - the reference's|."""
    return margins["iou_margin"] + margins["yardstick_iou_scale"] * np.abs(iou - iou_yard)


def sample_decisions(images: List[Dict[str, np.ndarray]], dec, margins, yard: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, list]:
    """The reference's walks over one sample's candidates (`rig.candidates`,
    with `rot_g` / `tvec_g`): per image the final `kept` mask and the firmly
    kept and firmly suppressed masks of the BEV walks; `yard`, the
    yardstick's `geometry` at the same candidates, sets each pair's IoU
    margin."""
    t, cap = dec["BEV_NMS_IOU_THRESH"], int(dec["SAMPLE_MAX_DETS"])
    sm = margins["score_margin"]
    out = {"kept": [], "firm_kept": [], "firm_out": []}
    stage = []
    for b, image in enumerate(images):
        fk2, fs2 = compare.firm(image, dec, sm, margins["iou_margin"])
        maybe = image["valid"] & ~fs2
        bev = rig.bev_boxes(image["rot"], image["tvec"], image["size"], rig.CAMERA_TO_BEV)
        iou = rig.same_class_iou(bev, image["cls"], among=maybe)
        iou_y = rig.same_class_iou(rig.bev_boxes(yard[b]["rot"], yard[b]["tvec"], yard[b]["size"], rig.CAMERA_TO_BEV),
                                   image["cls"], among=maybe)
        kept_b = rig.walk(iou, image["kept"], image["cls"], t)
        fkb, fsb = staged(iou, image["cls"], image["score3d"], fk2, ~maybe, kept_b, t, sm,
                          pair_margins(iou, iou_y, margins))
        stage.append((kept_b, fkb, fs2 | fsb, fsb))
    dets = [{"score3d": im["score3d"], "cls": im["cls"], "rot_g": im["rot_g"], "tvec_g": im["tvec_g"],
             "size": im["size"]} for im in images]
    who = rig.sample_order(dets)
    pick = lambda j: np.array([stage[c][j][i] for c, i in who], bool)  # noqa: E731
    cls = np.array([images[c]["cls"][i] for c, i in who], np.int64)
    score = np.array([images[c]["score3d"][i] for c, i in who])
    maybe = ~pick(2) & np.array([images[c]["valid"][i] for c, i in who], bool)
    iou = rig.same_class_iou(rig.global_bev(dets, who), cls, among=maybe)
    iou_y = rig.same_class_iou(rig.global_bev(yard, who), cls, among=maybe)
    kept_s = rig.walk(iou, pick(0), cls, t, cap)
    fks, fss = staged(iou, cls, score, pick(1), ~maybe, kept_s, t, sm, pair_margins(iou, iou_y, margins), cap)
    for c, image in enumerate(images):
        n = len(image["cls"])
        out["kept"].append(np.zeros(n, bool))
        out["firm_kept"].append(np.zeros(n, bool))
        out["firm_out"].append(stage[c][3].copy())
    for (c, i), k, f, s in zip(who, kept_s, fks, fss):
        out["kept"][c][i], out["firm_kept"][c][i] = k, f
        out["firm_out"][c][i] |= s
    return out


def _largest_overlap(served: List[Dict[str, np.ndarray]]) -> float:
    rot = np.concatenate([s["rot_g"] for s in served])
    if len(rot) < 2:
        return 0.0
    cls = np.concatenate([s["cls"] for s in served])
    bev = rig.bev_boxes(rot, np.concatenate([s["tvec_g"] for s in served]),
                        np.concatenate([s["size"] for s in served]), rig.VEHICLE_TO_BEV)
    iou = rig.same_class_iou(bev, cls)
    np.fill_diagonal(iou, 0.0)
    return float(iou.max())


def sample_readings(served: List[Dict[str, np.ndarray]], outputs, levels, images: List[Dict[str, np.ndarray]],
                    decisions: Dict[str, list], intrinsics: torch.Tensor, pose_quat, pose_tvec, dec, margins,
                    device) -> Dict[str, object]:
    """One sample's readings: `IMAGE` per image (lists), `SAMPLE` and
    `COUNTS`, and the served and reference largest overlaps."""
    out = {k: [] for k in IMAGE}
    out.update(dict.fromkeys(COUNTS, 0))
    global_gaps, n_served, n_ref = [], 0, 0
    for b, (got, image) in enumerate(zip(served, images)):
        final = decisions["kept"][b]
        gaps = compare.image_gaps(got, levels, b, dict(image, kept=final), dec, margins, device)
        for k in ("det_gap", "det_mean", "depth_gap"):
            out[k].append(gaps[k])
        stands, attr_bad, speed = set(), [], []
        for l in np.unique(got["level"]) if len(got["cls"]) else []:
            sel = np.nonzero(got["level"] == l)[0]
            _, loc = compare.match(got, levels[int(l)], b, sel, device)
            loc = loc.cpu().numpy()
            ref = rig.at(outputs, b, np.full(len(sel), l), loc, got["cls"][sel], intrinsics[b], dec)
            stands |= set(zip([int(l)] * len(sel), loc.tolist(), got["cls"][sel].tolist()))
            attr_bad += (got["attr"][sel] != ref["attr"]).tolist()
            speed += (np.abs(got["speed"][sel] - ref["speed"]) / (1.0 + np.abs(ref["speed"]))).tolist()
            rot_g, tvec_g = rig.to_global(ref["rot"], ref["tvec"], pose_quat[b], pose_tvec[b])
            global_gaps += np.maximum(np.abs(got["rot_g"][sel] - rot_g).max(axis=(1, 2)),
                                      np.linalg.norm(got["tvec_g"][sel] - tvec_g, axis=1) / (1.0 + ref["depth"])
                                      ).tolist()
        out["attr_mismatch"].append(float(np.mean(attr_bad)) if attr_bad else 0.0)
        out["speed_gap"].append(float(np.mean(speed)) if speed else 0.0)
        ident = list(zip(image["level"].tolist(), image["loc"].tolist(), image["cls"].tolist()))
        firm_kept, firm_out = decisions["firm_kept"][b], decisions["firm_out"][b]
        out["n_firm_kept"] += int(firm_kept.sum())
        out["n_firm_suppressed"] += int(firm_out.sum())
        out["n_missed"] += sum(ident[j] not in stands for j in np.nonzero(firm_kept)[0])
        out["n_suppressed_served"] += sum(ident[j] in stands for j in np.nonzero(firm_out)[0])
        n_served, n_ref = n_served + len(got["cls"]), n_ref + int(final.sum())
    out["count_gap"] = abs(n_served - n_ref) / max(n_ref, 1)
    out["global_gap"] = float(np.mean(global_gaps)) if global_gaps else 0.0
    out["overlap"] = _largest_overlap(served)
    out["ref_overlap"] = _largest_overlap([{"rot_g": im["rot_g"][k], "tvec_g": im["tvec_g"][k],
                                            "size": im["size"][k], "cls": im["cls"][k]}
                                           for im, k in zip(images, decisions["kept"])])
    out["images"] = len(served)
    return out


def summarize(samples: List[Dict[str, object]], least_decisions: float = 0.0) -> Dict[str, float]:
    """The numbers over a sample of samples: each per-image number's mean
    over the images, each per-sample number's mean over the samples, the
    shares over at least `least_decisions` an image, the largest overlaps."""
    out = {k: float(np.mean([x for s in samples for x in s[k]])) if samples else 0.0 for k in IMAGE}
    out.update({k: float(np.mean([s[k] for s in samples])) if samples else 0.0 for k in SAMPLE})
    total = {k: sum(s[k] for s in samples) for k in COUNTS}
    out.update(total)
    least = max(least_decisions * sum(s["images"] for s in samples), 1)
    out["sample_kept_missed"] = total["n_missed"] / max(total["n_firm_kept"], least)
    out["sample_suppressed_served"] = total["n_suppressed_served"] / max(total["n_firm_suppressed"], least)
    out["sample_overlap"] = max([s["overlap"] for s in samples] + [0.0])
    out["ref_sample_overlap"] = max([s["ref_overlap"] for s in samples] + [0.0])
    out["sample_overlap_gap"] = abs(out["sample_overlap"] - out["ref_sample_overlap"])
    return out


def readings(got: Dict[str, float], yard: Dict[str, float]) -> Dict[str, float]:
    """The compared numbers: ratios and excesses of the served numbers over
    the yardstick's (the reference in the configuration's own precision),
    which swing less from seed to seed than the gaps alone; and the
    yardstick's own numbers beside them."""
    out = dict(got)
    for k in ("det_gap", "det_mean", "depth_gap", "speed_gap", "global_gap"):
        out[k.replace("_gap", "") + "_ratio"] = got[k] / max(yard[k], 1e-12)
    for k in ("attr_mismatch", "sample_kept_missed", "sample_suppressed_served"):
        out[f"{k}_excess"] = got[k] - yard[k]
    out.update({f"yardstick_{k}": v for k, v in yard.items()})
    return out
