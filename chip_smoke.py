#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (dd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path for the dd3d_kitti_dla34 experiment (DLA-34 +
FPN + FCOS2D/FCOS3D heads at full width, bf16, channels_last) through
`build_model` -> `get_inference_fn` -> `infer(images, intrinsics)`, with
seeded random weights, and fails loudly (non-zero exit) if any phase fails:

1. build the greedy-NMS CUDA kernel (dd3d_tpu_torch/csrc/nms.cu) and hold its
   keep masks against the plain PyTorch version on the card, exactly;
2. serve 4 batches of 8 uint8 384x1280 images with KITTI intrinsics, and
   check the NMS input, the kernel's launch count, shapes and finiteness;
3. decode the same batch with the plain suppression on the card: the
   detections must be identical;
4. fp32 on the card (TF32 off) against fp32 on the CPU, on a small batch;
5. timing: images/s of phase 2 and the NMS kernel against the plain version.

Needs one CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); no network.
The last line printed is {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

KITTI_K = [[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]]
HEIGHT, WIDTH, BATCH, N_BATCHES = 384, 1280, 8, 4
NMS_SHAPE = (8, 512)  # (B, N) of the serving path: batch 8, TPU.NMS_CANDIDATES = 512
SEED = 0


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def randomize_state(model, generator):
    """Non-degenerate seeded weights, like tests/torch_ref_dd3d.randomize_state:
    convs, norm affines N(0, 0.1), running_var U(0.5, 1). Scale/Offset keep
    their stride / depth-statistic inits, and the box regression gets a +4
    bias, so the 2D boxes span a few strides and NMS has overlaps to resolve."""
    from dd3d_tpu_torch.models.layers import Offset, Scale

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Scale, Offset)):
                continue
            for name, t in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
                if name in ("weight", "bias", "running_mean"):
                    t.copy_(torch.randn(t.shape, generator=generator) * 0.1)
                elif name == "running_var":
                    t.copy_(torch.rand(t.shape, generator=generator) * 0.5 + 0.5)
        model.fcos2d_head.box2d_reg.bias += 4.0


def build(cfg, device):
    from dd3d_tpu_torch.models import build_model

    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    randomize_state(model, torch.Generator().manual_seed(SEED + 1))
    return model.to(device)


def random_sorted_boxes(gen, b, n, device):
    boxes = torch.rand(b, n, 4, generator=gen) * 200
    boxes[..., 2:] = boxes[..., :2] + torch.rand(b, n, 2, generator=gen) * 80 + 1
    order = torch.argsort(torch.rand(b, n, generator=gen), dim=1)
    boxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    valid = torch.rand(b, n, generator=gen) > 0.05
    return boxes.to(device), valid.to(device)


def cuda_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase1_kernel(device):
    """Kernel vs plain keep masks on the card; returns (max_abs_err, (boxes, valid)) at the serving shape."""
    from dd3d_tpu_torch.ops.nms import batched_nms_padded
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    gen = torch.Generator().manual_seed(SEED)
    t0 = time.time()
    cases = []
    b, n = NMS_SHAPE
    serving = random_sorted_boxes(gen, b, n, device)
    for thr in (0.75, 0.5):
        cases.append((f"random B={b} N={n} thr={thr}", serving[0], serving[1], thr))
    boxes, valid = random_sorted_boxes(gen, 3, 300, device)  # N not a multiple of 128
    cases.append(("random B=3 N=300 thr=0.6", boxes, valid, 0.6))
    cases.append(("all invalid", boxes, torch.zeros_like(valid), 0.5))
    same = torch.tensor([10.0, 10.0, 50.0, 40.0], device=device).expand(2, 64, 4).contiguous()
    cases.append(("identical boxes", same, torch.ones(2, 64, dtype=torch.bool, device=device), 0.5))
    zero_area = boxes.clone()
    zero_area[..., 2] = zero_area[..., 0]
    cases.append(("zero-area boxes", zero_area, valid, 0.5))

    max_err = 0
    for name, bx, vd, thr in cases:
        keep_k = greedy_nms(bx, vd, thr)
        torch.cuda.synchronize()
        keep_p = greedy_nms_plain(bx, vd, thr)
        err = int((keep_k.int() - keep_p.int()).abs().max())
        max_err = max(max_err, err)
        log(f"phase1 {name}: kept {int(keep_k.sum())}/{int(vd.sum())} valid, "
            f"max |kernel - plain| = {err} (tolerance 0: keep masks must be equal)")
        if err:
            raise AssertionError(f"phase1 {name}: kernel and plain keep masks differ")
        if name == "identical boxes" and keep_k.sum(1).tolist() != [1, 1]:
            raise AssertionError("identical boxes: exactly the first must survive")
        if name == "all invalid" and keep_k.any():
            raise AssertionError("all invalid: nothing may be kept")

    # several classes: the class-offset trick in front of the kernel
    bx, vd = serving
    scores = torch.where(vd, torch.linspace(1.0, 0.0, n, device=device).expand(b, n), -1e10)
    classes = torch.randint(0, 5, (b, n), generator=gen).to(device)
    res_k = batched_nms_padded(bx, scores, classes, 0.5, 100, assume_sorted=True)
    res_p = batched_nms_padded(bx, scores, classes, 0.5, 100, assume_sorted=True, suppress=greedy_nms_plain)
    if not all(torch.equal(x, y) for x, y in zip(res_k, res_p)):
        raise AssertionError("phase1 several classes: kernel and plain differ")
    log(f"phase1 several classes B={b} N={n}: kept {int(res_k[1].sum())}, identical")
    torch.cuda.synchronize()
    log(f"phase1 ok ({time.time() - t0:.2f} s incl. the kernel build)")
    return max_err, serving


def make_batches(device):
    rng = np.random.RandomState(SEED)
    images = [torch.from_numpy(rng.randint(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)).to(device)
              for _ in range(N_BATCHES)]
    intrinsics = torch.tensor(KITTI_K, dtype=torch.float32, device=device).expand(BATCH, 3, 3).contiguous()
    return images, intrinsics


def phase2_serve(cfg, model, images, intrinsics):
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    candidates, survivors = [], []

    def counting_suppress(boxes, valid, thr):
        keep = greedy_nms(boxes, valid, thr)
        candidates.append(valid.sum(dim=1).cpu())
        survivors.append(keep.sum(dim=1).cpu())
        return keep

    infer = get_inference_fn(model, cfg, suppress=counting_suppress)
    t0 = time.time()
    greedy_nms.launches = 0
    dets = [infer(im, intrinsics) for im in images]
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    d = cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
    for i, det in enumerate(dets):
        for k, v in det.items():
            if v.shape[:2] != (BATCH, d):
                raise AssertionError(f"phase2 batch {i}: {k} has shape {tuple(v.shape)}")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"phase2 batch {i}: {k} is not finite")
        log(f"phase2 batch {i}: valid NMS candidates per image {candidates[i].tolist()}, "
            f"surviving suppression {survivors[i].tolist()}, detections {det['valid'].sum(dim=1).tolist()}")
        if int(candidates[i].min()) < 100:
            raise AssertionError("phase2: fewer than 100 valid NMS candidates in an image")
    if launches < N_BATCHES:
        raise AssertionError(f"phase2: NMS kernel launched {launches} times for {N_BATCHES} batches")
    if all(torch.equal(c, k) for c, k in zip(candidates, survivors)):
        raise AssertionError("phase2: NMS suppressed nothing; the check would be trivial")
    log(f"phase2 ok: {N_BATCHES} batches of {BATCH} at {HEIGHT}x{WIDTH}, NMS kernel launches {launches} "
        f"({time.time() - t0:.2f} s incl. first-call set-up)")
    return launches


def phase3_plain_path(cfg, model, images, intrinsics):
    from dd3d_tpu_torch.models.dd3d import dd3d_inference
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_plain

    with torch.inference_mode():
        outputs = model(images[0])
        det_k = dd3d_inference(cfg, outputs, intrinsics, model.strides)
        det_p = dd3d_inference(cfg, outputs, intrinsics, model.strides, suppress=greedy_nms_plain)
    torch.cuda.synchronize()
    for k in det_k:
        if not torch.equal(det_k[k], det_p[k]):
            raise AssertionError(f"phase3: {k} differs between the kernel path and the plain path")
    log(f"phase3 ok: kernel-path and plain-path detections identical ({int(det_k['valid'].sum())} kept)")


def phase4_fp32(cfg, device):
    """Tolerance: both sides are fp32, summed in other orders by cuDNN and by
    the CPU's convolutions (a few ulps per layer over ~40 layers), so each
    head output must agree to 1e-3 of its own largest magnitude."""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = build(cfg, "cpu")
    gpu_model = build(cfg, device)
    rng = np.random.RandomState(SEED + 2)
    images = torch.from_numpy(rng.randint(0, 256, (2, 128, 384, 3), dtype=np.uint8))
    with torch.inference_mode():
        ref = cpu_model(images)
        out = gpu_model(images.to(device))
    torch.cuda.synchronize()
    worst = 0.0
    for k in ref:
        for lvl, (a, b) in enumerate(zip(out[k], ref[k])):
            err = float((a.cpu() - b).abs().max())
            rel = err / max(float(b.abs().max()), 1e-12)
            worst = max(worst, rel)
            if rel > 1e-3:
                raise AssertionError(f"phase4: {k} level {lvl}: max |card - cpu| = {err} ({rel:.2e} relative)")
    log(f"phase4 ok: fp32 card vs CPU head outputs, worst relative error {worst:.3e} (limit 1e-3)")


def phase5_timing(cfg, model, images, intrinsics, serving_nms):
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    infer = get_inference_fn(model, cfg)
    for im in images[:2]:  # warm-up
        infer(im, intrinsics)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        for im in images:
            t0 = time.perf_counter()
            infer(im, intrinsics)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    log(f"phase5 serving: batch {BATCH} {HEIGHT}x{WIDTH} bf16, median {med * 1e3:.3f} ms/batch over "
        f"{len(times)} batches (p25 {np.percentile(times, 25) * 1e3:.3f}, p75 {np.percentile(times, 75) * 1e3:.3f}) "
        f"= {BATCH / med:.1f} images/s, input already on the card")

    bx, vd = serving_nms
    thr = cfg.DD3D.FCOS2D.INFERENCE.NMS_THRESH
    for _ in range(3):
        greedy_nms(bx, vd, thr)
        greedy_nms_plain(bx, vd, thr)
    plain_a = cuda_ms(lambda: greedy_nms_plain(bx, vd, thr), 20)
    kern_a = cuda_ms(lambda: greedy_nms(bx, vd, thr), 200)
    kern_b = cuda_ms(lambda: greedy_nms(bx, vd, thr), 200)
    plain_b = cuda_ms(lambda: greedy_nms_plain(bx, vd, thr), 20)
    kern_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    log(f"phase5 nms at (B, N) = {NMS_SHAPE}, thr {thr}: kernel {kern_a:.4f} / {kern_b:.4f} ms, "
        f"plain {plain_a:.4f} / {plain_b:.4f} ms (plain, kernel, kernel, plain)")
    return BATCH / med, kern_ms, plain_ms


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    from dd3d_tpu_torch.configs import get_experiment_cfg

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    max_err, serving_nms = phase1_kernel(device)
    torch.cuda.synchronize()

    cfg = get_experiment_cfg("dd3d_kitti_dla34")  # bf16 serving config
    model = build(cfg, device)
    images, intrinsics = make_batches(device)
    launches = phase2_serve(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase3_plain_path(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase4_fp32(get_experiment_cfg("dd3d_kitti_dla34"), device)
    torch.cuda.synchronize()
    imgs_per_s, kern_ms, plain_ms = phase5_timing(cfg, model, images, intrinsics, serving_nms)
    torch.cuda.synchronize()

    log(f"timing on {card}: {imgs_per_s:.1f} images/s (batch {BATCH}, {HEIGHT}x{WIDTH}, bf16); "
        f"NMS kernel {kern_ms:.4f} ms vs plain {plain_ms:.4f} ms at {NMS_SHAPE}")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "greedy_nms", "route": "cuda", "source": "dd3d_tpu_torch/csrc/nms.cu",
        "replaces": "dd3d_tpu/ops/pallas_nms.py:40", "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
