"""The rig serving mode: a closed loop of one client, each request a batch
of whole samples of a rig of cameras (host frames, each camera's
intrinsics, the camera -> global poses) through the program's serving
entry with its sample aggregation, host detections out; then the check of
a seeded sample of the served samples against the plain rig reference
(`reference/compare_rig.py`).

A rig traffic file is a serving mix (harness/traffic.py: `batch`, `frame`,
`min_size_test`, `canvas`, `pool`, `structure`, `contrast`) whose
`cameras` list each camera's calibrated `intrinsics` (scaled by the
resize, as the frames are), its `yaw_deg` about the vehicle's up axis and
its `mount_m` (x forward, y left, z up), level; a batch holds
`batch / len(cameras)` samples, cameras in that order, and each sample an
ego -> global pose drawn from the seed: a yaw in `ego_yaw_deg` and a
translation of up to `ego_translation_m` in x and y.

It builds the server itself (`build_server`): harness/program.py's passes
no `group_size`, so the program would never aggregate. The rest is
harness/serve.py's: its `Serve`'s window and release, its `Window`, and the
`Context` its runs build, so that the readers read this cell as they read
the others.
"""
import contextlib
import copy
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from harness import program, serve, traffic as traffic_gen
from reference import compare_rig, decode, plain, rig, weights

# the camera's axes (x right, y down, z forward) in the vehicle's (x forward, y left, z up), as a wxyz quaternion
CAMERA_AXES = (0.5, -0.5, 0.5, -0.5)


def quat_mul(a, b) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def yaw_quat(deg: float) -> np.ndarray:
    half = math.radians(deg) / 2
    return np.array([math.cos(half), 0.0, 0.0, math.sin(half)])


def rig_pool(traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """`pool` batches: harness/traffic.serve_pool's frames, and each image's
    camera intrinsics (B, 3, 3), `pose_quat` (B, 4) wxyz and `pose_tvec`
    (B, 3), camera -> global."""
    cams = traffic["cameras"]
    b = int(traffic["batch"])
    if b % len(cams):
        raise ValueError(f"a batch of {b} holds no whole samples of {len(cams)} cameras")
    pool = traffic_gen.serve_pool(dict(traffic, intrinsics=cams[0]["intrinsics"]), seed, device)
    _, _, s = traffic_gen.resized(traffic["frame"], int(traffic["min_size_test"]))
    ks = np.stack([np.array(c["intrinsics"], np.float64) * [[s], [s], [1.0]] for c in cams]).astype(np.float32)
    rng = np.random.default_rng(traffic_gen.derive(seed, "poses"))
    reach = float(traffic["ego_translation_m"])
    for batch in pool:
        quats, tvecs = [], []
        for _ in range(b // len(cams)):
            yaw = rng.uniform(*traffic["ego_yaw_deg"])
            ego_t = np.array([*rng.uniform(-reach, reach, 2), 0.0])
            c, s_ = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
            ego_r = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
            for cam in cams:
                quats.append(quat_mul(yaw_quat(yaw), quat_mul(yaw_quat(cam["yaw_deg"]), CAMERA_AXES)))
                tvecs.append(ego_r @ np.array(cam["mount_m"], np.float64) + ego_t)
        batch["intrinsics"] = np.tile(ks, (b // len(cams), 1, 1))
        batch["pose_quat"] = np.array(quats, np.float32)
        batch["pose_tvec"] = np.array(tvecs, np.float32)
    return pool


def build_server(config: dict, state_dict: Dict, device, group_size: int):
    """The program's serving entry for `config` with its sample aggregation
    over runs of `group_size` images, its weights loaded from the
    reference-named `state_dict` through the program's own renaming."""
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.utils.convert_checkpoint import reference_to_port_names

    cfg = program.experiment_cfg(config)
    model = build_model(cfg).to(device)
    model.load_state_dict(reference_to_port_names(state_dict, model), strict=True)
    return get_inference_fn(model, cfg, group_size=group_size)


@contextlib.contextmanager
def bev_nms_arguments(change, where=("dd3d", "sample_bev_nms")):
    """The program's rotated BEV NMS (`rotated_nms_padded`, as the
    per-image decode, models/dd3d.py, and the sample aggregation,
    ops/sample_bev_nms.py, call it) run on `change(args, kwargs)`."""
    from dd3d_tpu_torch.models import dd3d
    from dd3d_tpu_torch.ops import sample_bev_nms

    modules = {"dd3d": dd3d, "sample_bev_nms": sample_bev_nms}
    originals = {w: modules[w].rotated_nms_padded for w in where}
    for w, original in originals.items():
        def patched(*args, _original=original, **kwargs):
            args, kwargs = change(args, kwargs)
            return _original(*args, **kwargs)
        modules[w].rotated_nms_padded = patched
    try:
        yield
    finally:
        for w, original in originals.items():
            modules[w].rotated_nms_padded = original


class RigServe(serve.Serve):
    """Set-up of a rig cell: frames, poses and weights from the seed, then
    the program's server with its sample aggregation and a warm-up.
    `fault`, for the harness's own tests, wraps the serving entry."""

    def __init__(self, cell, seed: int, device, fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.pool = rig_pool(cell.traffic, seed, device)
        self.state_dict = weights.make_state_dict(plain.build(cell.config["model"], device).state_dict(),
                                                  traffic_gen.derive(seed, "weights"), device)
        infer = build_server(cell.config, self.state_dict, device, len(cell.traffic["cameras"]))
        self.infer = fault(infer) if fault else infer
        for i in range(int(cell.traffic.get("warmup_batches", 2))):
            self.request(self.pool[i % len(self.pool)])
        if device != "cpu":
            torch.cuda.synchronize()

    def request(self, batch: Dict[str, np.ndarray]):
        return self.infer(batch["images"], batch["intrinsics"], batch["pose_quat"], batch["pose_tvec"])


def decoding(cell) -> dict:
    return dict(cell.config["decode"], strides=list(cell.config["model"]["strides"]))


def reference_outputs(cell, ref, pool, device, how: dict):
    """`outputs(frames)` -> the reference's outputs in a stated precision:
    {"dtype": ...} casts a copy of the model and its input; {"bits",
    "min_ch", "calibration_batches"} fake-quantizes as
    harness/serve.reference_producer does."""
    if "dtype" in how:
        dtype = getattr(torch, how["dtype"])
        low = copy.deepcopy(ref).to(dtype)

        def outputs(frames):
            with torch.no_grad():
                return low(frames.permute(0, 3, 1, 2).to(dtype))
        return outputs
    bits, min_ch = int(how["bits"]), int(how["min_ch"])
    block = int(cell.traffic.get("reference_block", 8))
    batches = (torch.as_tensor(pool[i]["images"][j:j + block], device=device)
               for i in range(int(how["calibration_batches"])) for j in range(0, int(cell.traffic["batch"]), block))
    amax = plain.calibrate(ref, batches, min_ch)

    def outputs(frames):
        with plain.quantized(ref, amax, bits, min_ch):
            return plain.forward(ref, frames)
    return outputs


def served_by(cell, outputs, k, pose_quat, pose_tvec):
    """A sample's served detections as the reference works them out from
    `outputs` (`reference.rig.serve_sample`)."""
    dec = decoding(cell)
    return rig.serve_sample(outputs, decode.dense_levels(outputs, k, dec["strides"], dec), k, pose_quat, pose_tvec,
                            dec)


def reference_readings(cell, seed: int, pool, served: List[tuple], state_dict, device, control=None) -> dict:
    """The comparison's numbers (reference/compare_rig.py) over a sample,
    drawn from the seed, of the samples the window served, against the
    reference in f32 (TF32 off), and the same of the reference in the
    configuration's own precision (its yardstick) over the same samples:
    ratios and excesses of the one over the other. `control`, a
    `reference_outputs` spec, stands the reference in a lower precision
    in for the served detections. The firm decisions' BEV IoU margins
    come from the yardstick's own boxes at the reference's candidates
    (`compare_rig.geometry`)."""
    cams = len(cell.traffic["cameras"])
    per_batch = int(cell.traffic["batch"]) // cams
    total = len(served) * per_batch
    rng = np.random.default_rng(traffic_gen.derive(seed, "sample"))
    picks = rng.choice(total, size=min(int(cell.traffic["sample_images"]) // cams, total), replace=False)
    plain.strict_f32()
    ref = plain.build(cell.config["model"], device)
    ref.load_state_dict(state_dict)
    yardstick = reference_outputs(cell, ref, pool, device, cell.config["yardstick"])
    lower = reference_outputs(cell, ref, pool, device, control) if control else None
    dec, margins = decoding(cell), cell.config["compare"]
    got, yard = [], []
    for pick in sorted(int(x) for x in picks):
        bi, s = divmod(pick, per_batch)
        p, det = served[bi]
        idx = slice(s * cams, (s + 1) * cams)
        frames = torch.as_tensor(pool[p]["images"][idx], device=device)
        k = torch.as_tensor(pool[p]["intrinsics"][idx], device=device)
        pose_quat, pose_tvec = pool[p]["pose_quat"][idx], pool[p]["pose_tvec"][idx]
        outputs = plain.forward(ref, frames)
        levels = decode.dense_levels(outputs, k, dec["strides"], dec)
        images = rig.candidates(outputs, levels, k, dec)
        for b, image in enumerate(images):
            image["rot_g"], image["tvec_g"] = rig.to_global(image["rot"], image["tvec"], pose_quat[b], pose_tvec[b])
        yard_out = yardstick(frames)
        decisions = compare_rig.sample_decisions(
            images, dec, margins, compare_rig.geometry(yard_out, images, k, pose_quat, pose_tvec, dec))
        mine = (served_by(cell, lower(frames), k, pose_quat, pose_tvec) if lower
                else compare_rig.served_images({key: v[idx] for key, v in det.items()}))
        args = (outputs, levels, images, decisions, k, pose_quat, pose_tvec, dec, margins, device)
        got.append(compare_rig.sample_readings(mine, *args))
        yard.append(compare_rig.sample_readings(served_by(cell, yard_out, k, pose_quat, pose_tvec), *args))
    least = margins["least_decisions"]
    readings = compare_rig.readings(compare_rig.summarize(got, least), compare_rig.summarize(yard, least))
    readings["images"] = len(picks) * cams
    return readings


def run(cell, seed: int, seconds: float, trace: bool, device, start: float, fault=None):
    """Set-up, the window, then the reference check; see harness/cellrun.py."""
    from harness.cellrun import Context, Outcome

    cuda = device != "cpu"
    s = RigServe(cell, seed, device, fault)
    gc.collect()
    gc.freeze()  # what set-up made is never scanned again: no full collection of the model in the window
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start
    w = s.window(seconds, trace)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    pool, state_dict = s.pool, s.state_dict
    s.release()
    readings = reference_readings(cell, seed, pool, w.served, state_dict, device)
    values = {
        "setup_s": setup_s,
        "serve_images_per_s": w.images / w.seconds,
        "peak_mem_gib": window_peak / 2 ** 30,
    }
    ctx = Context(cell, w.trace.window_s if trace else w.seconds, w.batches, w.images,
                  {"enqueue_s": w.enqueue_s}, w.counters, w.trace if trace else None)
    return Outcome(values, ctx, readings, attempted=w.batches, failed=0,
                   memory_peak_bytes=int(max(setup_peak, window_peak)))
