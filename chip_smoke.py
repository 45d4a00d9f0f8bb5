#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (dd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths for the dd3d_kitti_dla34 experiment
(DLA-34 + FPN + FCOS2D/FCOS3D heads at full width, channels_last), bf16 and
bench.py's static int8 (QUANT_MIN_CH=32, QUANT_UNFOLDED), through
`build_model` -> [`prepare_static_scales`] -> `get_inference_fn` ->
`infer(images, intrinsics)`, with seeded random weights, and fails loudly
(non-zero exit) if any phase fails. The three CUDA kernels are built first,
one nvcc process each, all at once.

1. build the greedy-NMS CUDA kernel (dd3d_tpu_torch/csrc/nms.cu) and hold its
   keep masks against the plain PyTorch version on the card, exactly;
2. serve 4 batches of 8 uint8 384x1280 images with KITTI intrinsics, and
   check the NMS input, the kernel's launch count, shapes and finiteness;
3. decode the same batch with the plain suppression on the card: the
   detections must be identical;
4. fp32 on the card (TF32 off) against fp32 on the CPU, on a small batch;
5. timing: images/s of phase 2 and the NMS kernel against the plain version;
6. the int8 quantize kernel (csrc/quantize.cu) against its plain version,
   exactly: the serving shape, ragged shapes, .5 ties, the clip, dynamic and
   static scales;
7. the int8 conv kernel (csrc/int8_conv.cu) against its plain version at
   every conv shape the int8 path reaches at 384x1280 (the stem's too):
   int32 accumulators exactly, bf16 and f32 epilogues bit for bit;
8. the static-int8 path: calibrate on 2 batches, serve 4 batches of 8, check
   the launch counts of all three kernels and that no scale missed; the
   plain int8 versions give identical detections; drift against bf16 is
   bounded as in tests/test_int8_infer.py;
9. timing: images/s of int8 and bf16 in turns, and each int8 kernel against
   its plain version at a serving shape.

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


def serving_ms(infer, images, intrinsics):
    """Median and quartiles of ms a batch over 3 passes of `images`, after 2
    warm-up batches; input already on the card."""
    for im in images[:2]:
        infer(im, intrinsics)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        for im in images:
            t0 = time.perf_counter()
            infer(im, intrinsics)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(times, [50, 25, 75])


def phase5_timing(cfg, model, images, intrinsics, serving_nms):
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    med, p25, p75 = serving_ms(get_inference_fn(model, cfg), images, intrinsics)
    log(f"phase5 serving: batch {BATCH} {HEIGHT}x{WIDTH} bf16, median {med:.3f} ms/batch over "
        f"{3 * len(images)} batches (p25 {p25:.3f}, p75 {p75:.3f}) = {BATCH / med * 1e3:.1f} images/s, "
        f"input already on the card")

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
    return BATCH / med * 1e3, kern_ms, plain_ms


QUANT_SHAPE = (8, 48, 160, 256)  # a P3 tower-conv input of the serving path, NHWC


def phase6_quantize(device):
    """quantize_int8 kernel vs plain on the card, exact int8 equality: the
    serving shape and ragged ones, bf16 and f32, a base that is not 16-byte
    aligned, .5 ties and the +-127 clip, dynamic and static scales. Returns
    (max_abs_err, (x, xs)) at the serving shape."""
    from dd3d_tpu_torch.ops.int8_conv import activation_scale
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    gen = torch.Generator().manual_seed(SEED + 3)
    t0 = time.time()
    serving = (torch.randn(QUANT_SHAPE, generator=gen) * 3).to(torch.bfloat16).to(device)
    # xs = 15.875 / 127 = 0.125 exactly: (k + 0.5) * 0.125 are exact .5 ties of
    # x / xs, and |x| up to 24 runs past 127 * 0.125 = 15.875 into the clip.
    ties = ((torch.randint(-200, 200, (4, 9, 17, 16), generator=gen) + 0.5) * 0.125).to(device)
    ragged = torch.randn(3, 7, 13, 5, generator=gen).to(device)
    cases = [
        ("serving bf16, dynamic", serving, activation_scale(serving, None)),
        ("serving bf16, static 4.0", serving, activation_scale(serving, 4.0)),
        ("ties and clip f32, static 15.875", ties, activation_scale(ties, 15.875)),
        ("ties and clip bf16, static 15.875", ties.to(torch.bfloat16), activation_scale(ties, 15.875)),
        ("ragged f32 (3,7,13,5), dynamic", ragged, activation_scale(ragged, None)),
        ("ragged bf16 (3,7,13,5), static 0.7", ragged.to(torch.bfloat16), activation_scale(ragged, 0.7)),
        ("unaligned bf16 base", serving.reshape(-1)[3:1003], activation_scale(serving, None)),
    ]
    max_err = 0
    for name, x, xs in cases:
        q_k = quantize_int8(x, xs)
        torch.cuda.synchronize()
        q_p = quantize_int8_plain(x, xs)
        err = int((q_k.int() - q_p.int()).abs().max())
        max_err = max(max_err, err)
        ratio = x.float() / xs
        n_ties = int((ratio - ratio.floor() == 0.5).sum())
        n_clip = int((ratio.abs() > 127.5).sum())
        log(f"phase6 {name}: {x.numel()} elements, {n_ties} exact .5 ties, {n_clip} clipped, "
            f"max |kernel - plain| = {err} (tolerance 0: codes must be equal)")
        if err:
            raise AssertionError(f"phase6 {name}: kernel and plain codes differ")
        if name.startswith("ties") and (n_ties < 100 or n_clip < 100):
            raise AssertionError(f"phase6 {name}: the input hits too few ties or clips to check them")
    log(f"phase6 ok ({time.time() - t0:.2f} s incl. the kernel build)")
    return max_err, (serving, cases[0][2])


def int8_conv_sites(model, images):
    """Every distinct int8 conv the static-int8 path reaches on `images`, as
    {(B, H, W, C, O, k, stride): count per forward}: one forward with every
    eligible conv quantized (QUANT_MIN_CH=0, the calibration regime, which
    adds the stem and the 16-channel convs to the serving set) and the
    predictors too (QUANT_UNFOLDED), recording the shapes that reach
    int8_conv_dequant."""
    import dd3d_tpu_torch.models.layers as L

    sites = {}
    real = L.int8_conv_dequant

    def record(x, weight, bias, stride, pad, out_dtype, act_amax=None, plain=False):
        key = (x.shape[0], x.shape[2], x.shape[3], x.shape[1], weight.shape[0], weight.shape[2], stride)
        sites[key] = sites.get(key, 0) + 1
        return real(x, weight, bias, stride, pad, out_dtype, act_amax, plain)

    L.int8_conv_dequant = record
    try:
        with torch.inference_mode(), L.quant_scope(L.QuantSpec(enabled=True, min_ch=0, unfolded=True, plain=True)):
            model(images)
    finally:
        L.int8_conv_dequant = real
    return sites


def phase7_int8_conv(model, images):
    """int8_conv kernel vs plain on the card at every conv shape of the int8
    path at the serving size: int32 accumulators exactly (scale 1, f32 out,
    every |acc| below 2^24 so f32 holds it exactly) and the dequant epilogue
    bit for bit (bf16 out with bias, and f32 out with bias). Returns
    (max_abs_err, sites, the P3 tower-conv case for timing)."""
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv, int8_conv_acc_plain

    t0 = time.time()
    sites = int8_conv_sites(model, images)
    gen = torch.Generator().manual_seed(SEED + 4)
    device = images.device
    max_err, timing_case = 0.0, None
    for (b, h, w, c, o, k, stride), count in sorted(sites.items()):
        pad = (k - 1) // 2
        xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8).to(device)
        wq = torch.randint(-127, 128, (o, k, k, c), generator=gen, dtype=torch.int8).to(device)
        scale = (torch.rand(o, generator=gen) * 1e-3 + 1e-5).to(device)
        bias = torch.randn(o, generator=gen).to(device)
        acc = int8_conv_acc_plain(xq, wq, stride, pad)
        if int(acc.abs().max()) >= 2 ** 24:
            raise AssertionError("phase7: accumulators beyond 2^24 would not be checked exactly in f32")
        ones = torch.ones(o, device=device)
        checks = [("acc", int8_conv(xq, wq, ones, None, stride, pad, torch.float32), acc.float())]
        for dt in (torch.bfloat16, torch.float32):
            got = int8_conv(xq, wq, scale, bias, stride, pad, dt)
            checks.append((str(dt), got, dequant_plain(acc, scale, bias, dt)))
        torch.cuda.synchronize()
        errs = []
        for name, got, want in checks:
            if got.shape != want.shape:
                raise AssertionError(f"phase7 {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            errs.append(float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"phase7 (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} {name}: "
                                     f"kernel and plain differ, max |diff| = {errs[-1]}")
        max_err = max(max_err, *errs)
        log(f"phase7 (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} x{count}/forward: accumulators, "
            f"bf16 and f32 epilogues equal (tolerance 0)")
        if (c, o, k, h) == (256, 256, 3, HEIGHT // 8):  # a tower conv at P3
            timing_case = (xq, wq, scale, bias, stride, pad)
    log(f"phase7 ok: {len(sites)} conv shapes, {sum(sites.values())} int8 convs a forward "
        f"({time.time() - t0:.2f} s incl. the kernel build)")
    return max_err, sites, timing_case


def int8_cfg():
    """bench.py's serving configuration: static int8 with QUANT_MIN_CH=32 and
    the predictors quantized too (bench.py:40-45)."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.QUANT_INT8 = True
    cfg.TPU.QUANT_MIN_CH = 32
    cfg.TPU.QUANT_UNFOLDED = True
    return cfg


def top_scores(det, n=50):
    return torch.sort(det["scores"].float().reshape(-1), descending=True).values[:n]


def phase8_int8_path(bf16_cfg, model, images, intrinsics, sites):
    """The static-int8 serving path: calibrate on 2 batches with
    prepare_static_scales, serve N_BATCHES batches through get_inference_fn,
    check every kernel's launch count and that no scale missed; the same
    batch through both plain int8 versions and the plain NMS gives identical
    detections; drift against bf16 within the bounds of
    tests/test_int8_infer.py:116-121. Returns (cfg, launches by kernel)."""
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.int8_conv import int8_conv
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    t0 = time.time()
    cfg = prepare_static_scales(int8_cfg(), model, images[:2], tag="chip_smoke")
    torch.cuda.synchronize()
    log(f"phase8 calibrated on 2 batches of {BATCH} ({time.time() - t0:.2f} s)")
    min_ch = cfg.TPU.QUANT_MIN_CH
    per_forward = sum(n for (_, _, _, c, _, _, _), n in sites.items() if c >= min_ch)

    infer = get_inference_fn(model, cfg)
    kernels = (quantize_int8, int8_conv, greedy_nms)
    for k in kernels:
        k.launches = 0
    dets = [infer(im, intrinsics) for im in images]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    log(f"phase8 served {N_BATCHES} batches of {BATCH} at {HEIGHT}x{WIDTH}, static int8: launches {launches}, "
        f"{per_forward} quantized convs a forward")
    expected = per_forward * N_BATCHES
    if launches["quantize_int8"] != expected or launches["int8_conv"] != expected:
        raise AssertionError(f"phase8: expected {expected} quantize and int8 conv launches, got {launches}")
    if launches["greedy_nms"] != N_BATCHES:
        raise AssertionError(f"phase8: NMS kernel launched {launches['greedy_nms']} times for {N_BATCHES} batches")
    if infer.quant.misses:
        raise AssertionError(f"phase8: static scales missed {infer.quant.misses[:5]}")
    d = cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
    for i, det in enumerate(dets):
        for k, v in det.items():
            if v.shape[:2] != (BATCH, d):
                raise AssertionError(f"phase8 batch {i}: {k} has shape {tuple(v.shape)}")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"phase8 batch {i}: {k} is not finite")
        if int(det["valid"].sum(dim=1).min()) == 0:
            raise AssertionError(f"phase8 batch {i}: an image has no detection")

    det_p = get_inference_fn(model, cfg, suppress=greedy_nms_plain, int8_plain=True)(images[0], intrinsics)
    torch.cuda.synchronize()
    for k in dets[0]:
        if not torch.equal(dets[0][k], det_p[k]):
            raise AssertionError(f"phase8: {k} differs between the int8 kernel path and the int8 plain path")
    log(f"phase8 int8 kernel-path and plain-path detections identical ({int(det_p['valid'].sum())} kept)")

    det_b = get_inference_fn(model, bf16_cfg)(images[0], intrinsics)
    sa, sb = top_scores(det_b), top_scores(dets[0])
    drift = float((sa - sb).abs().mean())
    mass = abs(float(sa.sum()) - float(sb.sum())) / max(float(sa.sum()), 1e-6)
    log(f"phase8 int8 vs bf16, top-50 scores of batch 0: mean |diff| {drift:.4f} (limit 0.05), "
        f"relative score mass {mass:.4f} (limit 0.25)")
    if drift >= 0.05 or mass >= 0.25:
        raise AssertionError("phase8: int8 detections drift too far from bf16")
    log(f"phase8 ok ({time.time() - t0:.2f} s)")
    return cfg, launches


def phase9_int8_timing(int8_cfg_static, bf16_cfg, model, images, intrinsics, quant_case, conv_case):
    """Images/s of the int8 and the bf16 path in turns (int8, bf16, bf16,
    int8), and each int8 kernel against its plain version at a serving
    shape (plain, kernel, kernel, plain). Returns {name: (ms, plain_ms)}."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    paths = {"int8": get_inference_fn(model, int8_cfg_static), "bf16": get_inference_fn(model, bf16_cfg)}
    runs = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        runs[name].append(serving_ms(paths[name], images, intrinsics))
    for name, rs in runs.items():
        med = [r[0] for r in rs]
        log(f"phase9 serving {name}: batch {BATCH} {HEIGHT}x{WIDTH}, median ms/batch {med[0]:.3f} / {med[1]:.3f} "
            f"(quartiles {rs[0][1]:.3f}-{rs[0][2]:.3f} / {rs[1][1]:.3f}-{rs[1][2]:.3f}) = "
            f"{BATCH / (np.mean(med) / 1e3):.1f} images/s")

    x, xs = quant_case
    xq, wq, scale, bias, stride, pad = conv_case
    timed = {
        "quantize_int8": (lambda: quantize_int8(x, xs), lambda: quantize_int8_plain(x, xs), 200, 50),
        "int8_conv": (lambda: int8_conv(xq, wq, scale, bias, stride, pad, torch.bfloat16),
                      lambda: int8_conv_plain(xq, wq, scale, bias, stride, pad, torch.bfloat16), 20, 3),
    }
    out = {}
    for name, (kern, plain, reps_k, reps_p) in timed.items():
        kern(), plain()
        p_a = cuda_ms(plain, reps_p)
        k_a = cuda_ms(kern, reps_k)
        k_b = cuda_ms(kern, reps_k)
        p_b = cuda_ms(plain, reps_p)
        out[name] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
        log(f"phase9 {name}: kernel {k_a:.4f} / {k_b:.4f} ms, plain {p_a:.4f} / {p_b:.4f} ms "
            f"(plain, kernel, kernel, plain)")
    xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2)
    cudnn = cuda_ms(lambda: torch.nn.functional.conv2d(xb, wb, stride=stride, padding=pad), 20)
    b, h, w, c = xq.shape
    gop = 2 * b * h * w * c * wq.shape[0] * wq.shape[1] * wq.shape[2] / stride ** 2 / 1e9
    log(f"phase9 int8 conv at {tuple(xq.shape)} -> {wq.shape[0]}, {wq.shape[1]}x{wq.shape[2]}: {gop:.1f} GOP, "
        f"kernel {gop / out['int8_conv'][0]:.1f} TOP/s; the same conv in bf16 through cuDNN {cudnn:.4f} ms "
        f"({gop / cudnn:.1f} TFLOP/s)")
    return {"int8": runs["int8"], "bf16": runs["bf16"]}, out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.kernels import build_libraries

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    build_libraries("nms.cu", "quantize.cu", "int8_conv.cu")  # one nvcc each, all at once
    log(f"kernels built in {time.time() - t0:.2f} s")

    nms_err, serving_nms = phase1_kernel(device)
    torch.cuda.synchronize()

    cfg = get_experiment_cfg("dd3d_kitti_dla34")  # bf16 serving config
    model = build(cfg, device)
    images, intrinsics = make_batches(device)
    bf16_nms_launches = phase2_serve(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase3_plain_path(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase4_fp32(get_experiment_cfg("dd3d_kitti_dla34"), device)
    torch.cuda.synchronize()
    imgs_per_s, nms_ms, nms_plain_ms = phase5_timing(cfg, model, images, intrinsics, serving_nms)
    torch.cuda.synchronize()

    quant_err, quant_case = phase6_quantize(device)
    torch.cuda.synchronize()
    conv_err, sites, conv_case = phase7_int8_conv(model, images[0])
    torch.cuda.synchronize()
    cfg8, launches = phase8_int8_path(cfg, model, images, intrinsics, sites)
    torch.cuda.synchronize()
    serving, kernel_ms = phase9_int8_timing(cfg8, cfg, model, images, intrinsics, quant_case, conv_case)
    torch.cuda.synchronize()

    int8_ips = BATCH / (np.mean([r[0] for r in serving["int8"]]) / 1e3)
    bf16_ips = BATCH / (np.mean([r[0] for r in serving["bf16"]]) / 1e3)
    log(f"timing on {card}: bf16 {imgs_per_s:.1f} images/s (phase 5); phase 9 in turns: static int8 "
        f"{int8_ips:.1f} images/s, bf16 {bf16_ips:.1f} images/s (batch {BATCH}, {HEIGHT}x{WIDTH}); "
        f"NMS kernel {nms_ms:.4f} ms vs plain {nms_plain_ms:.4f} ms at {NMS_SHAPE}; NMS launches on the bf16 "
        f"path {bf16_nms_launches}")
    print(card)
    print(json.dumps({"kernels": [
        {"name": "greedy_nms", "route": "cuda", "source": "dd3d_tpu_torch/csrc/nms.cu",
         "replaces": "dd3d_tpu/ops/pallas_nms.py:40", "launches": launches["greedy_nms"], "max_abs_err": nms_err,
         "ms": nms_ms, "plain_ms": nms_plain_ms},
        {"name": "quantize_int8", "route": "cuda", "source": "dd3d_tpu_torch/csrc/quantize.cu",
         "replaces": "scripts/bench_quantize_kernel.py:91", "launches": launches["quantize_int8"],
         "max_abs_err": quant_err, "ms": kernel_ms["quantize_int8"][0], "plain_ms": kernel_ms["quantize_int8"][1]},
        {"name": "int8_conv", "route": "cuda", "source": "dd3d_tpu_torch/csrc/int8_conv.cu",
         "replaces": "dd3d_tpu/models/layers.py:246", "launches": launches["int8_conv"], "max_abs_err": conv_err,
         "ms": kernel_ms["int8_conv"][0], "plain_ms": kernel_ms["int8_conv"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
