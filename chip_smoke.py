#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (dd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths for the dd3d_kitti_dla34 experiment
(DLA-34 + FPN + FCOS2D/FCOS3D heads at full width, channels_last), bf16 and
bench.py's static int8 (QUANT_MIN_CH=32, QUANT_UNFOLDED), through
`build_model` -> [`prepare_static_scales`] -> `get_inference_fn` ->
`infer(images, intrinsics)`, and its training path, through
`build_model` -> `train(cfg, batches, model)` with TPU.PALLAS_STEM_DW, with
seeded random weights and seeded synthetic batches, and fails loudly
(non-zero exit) if any phase fails. The four CUDA kernels are built first,
one nvcc process each, all at once.

1. build the greedy-NMS CUDA kernel (dd3d_tpu_torch/csrc/nms.cu) and hold its
   keep masks against the plain PyTorch version on the card, exactly;
2. serve 4 batches of 8 uint8 384x1280 images with KITTI intrinsics, and
   check the NMS input, the kernel's launch count, shapes and finiteness;
3. decode the same batch with the plain suppression on the card: the
   detections must be identical;
4. fp32 on the card (TF32 off) against fp32 on the CPU, on a small batch;
5. timing: images/s of phase 2 and the NMS kernel against the plain version
   and its bound, from the IoU tests that this data needs;
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
9. timing: images/s of int8 and bf16 in turns, each int8 kernel against
   its plain version and its bound at a serving shape, and the int8 conv
   kernel beside cuDNN's bf16 conv and its bound at every shape of phase 7,
   summed as count x ms a forward;
10. the stem weight-gradient kernel (csrc/conv_dw.cu) against its plain
    version on seeded bf16 inputs at the two stem shapes of the train step,
    the TPU benchmark's two shapes and a ragged one: within 1e-5 of
    sum|x*dy| of each output, and bit-identical over two launches;
11. training: 4 steps through `train()` at batch 8, 384x1280, bf16, with the
    stem's weight gradient on the kernel: finite losses, 2 launches a step,
    the FCOS2D BN statistics moved and no FrozenBN buffer; the same 4 steps
    with the plain dW give the same losses and step-1 stem gradients;
12. one fp32 train step on the card (TF32 off) against the CPU at 128x256:
    losses, gradients and updated parameters;
13. timing: ms per train step and images/s with the kernel and with the
    plain dW in turns, peak memory, device busy share, and the dW kernel
    against its plain version, cuDNN's bf16 wgrad and its bound at the stem
    shapes.

Before the last line, the card's name and power limit and one JSON line of
the four kernels: launches on the main path, error against the plain
version, ms, the plain version's ms, the bound (bytes or operations at the
published H100 peaks) and, where one PyTorch call computes the same thing,
that call's ms.

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
TRAIN_STEPS = 4
NMS_SHAPE = (8, 512)  # (B, N) of the serving path: batch 8, TPU.NMS_CANDIDATES = 512
SEED = 0

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): the
# least time the card could take for a kernel's work is the larger of its
# bytes over the memory rate and its operations over the peak of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound_ms(nbytes, ops, kind):
    """(ms, "bytes" or "operations"): each input read once, each output
    written once, against the operations of type `kind` at its peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


# f32 operations of one IoU test in csrc/nms.cu (2 min, 2 max, sub, max for
# each side; mul; add, sub; max; div; compare) and of one box's area.
NMS_OPS_PER_PAIR, NMS_OPS_PER_BOX = 14, 5


def nms_bound(boxes, valid, thr):
    """The NMS kernel's least time on these inputs: it tests box k against
    every later alive box j only while k is alive, so the pairs are counted
    by walking the same greedy suppression (on the CPU). Bytes: boxes and
    valid read, keep written. Returns (ms, bound_by, pairs, keep)."""
    b = boxes.cpu()
    alive = valid.cpu().clone()
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    pairs = 0
    for k in range(b.shape[1] - 1):
        later = alive[:, k + 1:] & alive[:, k:k + 1]
        pairs += int(later.sum())
        iw = (torch.minimum(x2[:, k:k + 1], x2[:, k + 1:]) - torch.maximum(x1[:, k:k + 1], x1[:, k + 1:])).clamp(min=0)
        ih = (torch.minimum(y2[:, k:k + 1], y2[:, k + 1:]) - torch.maximum(y1[:, k:k + 1], y1[:, k + 1:])).clamp(min=0)
        inter = iw * ih
        iou = inter / (area[:, k:k + 1] + area[:, k + 1:] - inter).clamp(min=1e-9)
        alive[:, k + 1:] &= ~(later & (iou > thr))
    nbytes = boxes.numel() * 4 + valid.numel() * 2
    ms, by = bound_ms(nbytes, NMS_OPS_PER_PAIR * pairs + NMS_OPS_PER_BOX * valid.numel(), "f32")
    return ms, by, pairs, alive


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
    bound, bound_by, pairs, keep = nms_bound(bx, vd, thr)
    if not torch.equal(keep, greedy_nms(bx, vd, thr).cpu()):
        raise AssertionError("phase5: the pair-counting walk and the kernel keep different boxes")
    log(f"phase5 nms at (B, N) = {NMS_SHAPE}, thr {thr}: kernel {kern_a:.4f} / {kern_b:.4f} ms, "
        f"plain {plain_a:.4f} / {plain_b:.4f} ms (plain, kernel, kernel, plain); {pairs} IoU tests on this "
        f"data: bound {bound:.6f} ms by {bound_by} ({bound / kern_ms:.2e} of the kernel's time)")
    return BATCH / med * 1e3, (kern_ms, plain_ms, bound, bound_by)


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
    (max_abs_err, sites, [(site, count, (xq, wq, scale, bias, stride, pad))],
    the P3 tower-conv case for timing)."""
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv, int8_conv_acc_plain

    t0 = time.time()
    sites = int8_conv_sites(model, images)
    gen = torch.Generator().manual_seed(SEED + 4)
    device = images.device
    max_err, timing_case, cases = 0.0, None, []
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
        cases.append(((b, h, w, c, o, k, stride), count, (xq, wq, scale, bias, stride, pad)))
        if (c, o, k, h) == (256, 256, 3, HEIGHT // 8):  # a tower conv at P3
            timing_case = cases[-1][2]
    log(f"phase7 ok: {len(sites)} conv shapes, {sum(sites.values())} int8 convs a forward "
        f"({time.time() - t0:.2f} s incl. the kernel build)")
    return max_err, sites, cases, timing_case


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


def int8_conv_bound(xq, wq, stride, pad, out_bytes=2):
    """Least time of one int8 conv: x and w read, the output written (bf16
    by default), against 2*M*O*K int8 operations (K of the unpadded C)."""
    b, h, w, c = xq.shape
    o, kh, kw, _ = wq.shape
    m = b * ((h + 2 * pad - kh) // stride + 1) * ((w + 2 * pad - kw) // stride + 1)
    return bound_ms(xq.numel() + wq.numel() + m * o * out_bytes + 8 * o, 2 * m * o * kh * kw * c, "int8")


def cudnn_bf16_conv(xq, wq, stride, pad):
    """cuDNN's bf16 conv of the same codes (exact operands, f32 sums): the
    library yardstick; the port never calls it for int8."""
    xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2)
    return lambda: torch.nn.functional.conv2d(xb, wb, stride=stride, padding=pad)


def device_ms(fn, reps, profiler):
    """Device time of one call of `fn`, from one profiler window over `reps`
    calls: every kernel in the window is charged to `fn` (a wrapper's own
    copies too), and the host's launch overhead does not inflate it (at a
    small shape the wrapper's host time exceeds the kernel's, so CUDA events
    around a loop of calls would time the host)."""
    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return us / 1e3 / reps


def int8_conv_sites_timing(cases, min_ch):
    """Device time of the int8 conv wrapper (its kernel, and the channel
    padding copy at the stem; bf16 out with bias, as served) and of cuDNN's
    bf16 conv, each in its own profiler window, at every conv shape of
    phase 7, summed as count x ms a forward over the serving set
    (C >= min_ch) and over all shapes, beside the sums of the bounds: the
    launches x gap figure that ranks the kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.int8_conv import int8_conv

    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    sums = {"serving": [0.0, 0.0, 0.0, 0], "all": [0.0, 0.0, 0.0, 0]}
    for (b, h, w, c, o, k, stride), count, (xq, wq, scale, bias, _, pad) in cases:
        k_ms = device_ms(lambda: int8_conv(xq, wq, scale, bias, stride, pad, torch.bfloat16), 10, prof)
        c_ms = device_ms(cudnn_bf16_conv(xq, wq, stride, pad), 10, prof)
        bnd, by = int8_conv_bound(xq, wq, stride, pad)
        log(f"phase9 int8 conv (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} x{count}/forward, device time: "
            f"kernel {k_ms:.4f} ms, cuDNN bf16 {c_ms:.4f} ms, bound {bnd:.5f} ms by {by} ({bnd / k_ms:.2f} of it)")
        for key in ("serving", "all") if c >= min_ch else ("all",):
            acc = sums[key]
            acc[0] += count * k_ms
            acc[1] += count * c_ms
            acc[2] += count * bnd
            acc[3] += count
    for key, (k_sum, c_sum, b_sum, n) in sums.items():
        log(f"phase9 int8 convs a forward, {key} ({n} convs), device time: kernel {k_sum:.3f} ms, cuDNN bf16 "
            f"{c_sum:.3f} ms, bound {b_sum:.3f} ms (count x ms summed over shapes)")
    return sums


def phase9_int8_timing(int8_cfg_static, bf16_cfg, model, images, intrinsics, quant_case, conv_case):
    """Images/s of the int8 and the bf16 path in turns (int8, bf16, bf16,
    int8), and each int8 kernel against its plain version at a serving
    shape (plain, kernel, kernel, plain), with its bound and, for the conv,
    cuDNN's bf16 conv of the same codes. Returns {name: (ms, plain_ms,
    bound_ms, bound_by, library_ms)}."""
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
    # quantize: bf16 in, int8 out, ~3 f32 operations an element
    q_bound = bound_ms(x.numel() * (x.element_size() + 1), 3 * x.numel(), "f32")
    out["quantize_int8"] += (*q_bound, None)
    cudnn = cuda_ms(cudnn_bf16_conv(xq, wq, stride, pad), 20)
    out["int8_conv"] += (*int8_conv_bound(xq, wq, stride, pad), cudnn)
    b, h, w, c = xq.shape
    gop = 2 * b * h * w * c * wq.shape[0] * wq.shape[1] * wq.shape[2] / stride ** 2 / 1e9
    for name, (k_ms, _, bnd, by, _) in out.items():
        log(f"phase9 {name}: bound {bnd:.4f} ms by {by}, {bnd / k_ms:.2f} of the kernel's time")
    log(f"phase9 int8 conv at {tuple(xq.shape)} -> {wq.shape[0]}, {wq.shape[1]}x{wq.shape[2]}: {gop:.1f} GOP, "
        f"kernel {gop / out['int8_conv'][0]:.1f} TOP/s; the same conv in bf16 through cuDNN {cudnn:.4f} ms "
        f"({gop / cudnn:.1f} TFLOP/s)")
    return {"int8": runs["int8"], "bf16": runs["bf16"]}, out


# (B, H, W, CI, CO, k): the stem's base_layer and level0 convs of the train
# step, scripts/bench_pallas_dw.py's two shapes at batch 8, and a ragged one
DW_SHAPES = [(BATCH, HEIGHT, WIDTH, 3, 16, 7), (BATCH, HEIGHT, WIDTH, 16, 16, 3), (BATCH, 192, 640, 12, 64, 5),
             (BATCH, 192, 640, 64, 64, 3), (3, 37, 53, 5, 7, 9)]
DW_BOUND = 1e-5


def dw_inputs(gen, b, h, w, ci, co, device, dtype=torch.bfloat16):
    """Seeded x (B, CI, H, W) and dy (B, CO, H, W), channels_last."""
    x = torch.randn(b, h, w, ci, generator=gen).to(device, dtype).permute(0, 3, 1, 2)
    dy = torch.randn(b, h, w, co, generator=gen).to(device, dtype).permute(0, 3, 1, 2)
    return x, dy


def dw_error_ratio(got, want, x, dy, k):
    """max |got - want| / sum|x*dy| over the outputs."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same_plain

    return float(((got - want).abs() / conv_dw_s1_same_plain(x.abs(), dy.abs(), k)).max())


def phase10_conv_dw(device):
    """conv_dw_s1_same kernel vs plain on the card. Tolerance: each output
    within DW_BOUND * sum|x*dy| of that output (f32 sums of up to 3.9 M
    exact bf16 products in other orders), and two launches bit-identical.
    Returns (max |kernel - plain| at the stem shapes, [(x, dy, k)] of the
    two stem shapes for timing)."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same, conv_dw_s1_same_plain

    gen = torch.Generator().manual_seed(SEED + 6)
    t0 = time.time()
    max_err, worst, stem = 0.0, 0.0, []
    for b, h, w, ci, co, k in DW_SHAPES:
        x, dy = dw_inputs(gen, b, h, w, ci, co, device)
        got = conv_dw_s1_same(x, dy, k)
        again = conv_dw_s1_same(x, dy, k)
        torch.cuda.synchronize()
        want = conv_dw_s1_same_plain(x, dy, k)
        ratio = dw_error_ratio(got, want, x, dy, k)
        err = float((got - want).abs().max())
        worst = max(worst, ratio)
        log(f"phase10 x ({b},{ci},{h},{w}) dy CO={co} k={k}: max |kernel - plain| = {err:.3e} "
            f"(largest |dW| {float(want.abs().max()):.1f}), worst / sum|x*dy| = {ratio:.3e} (limit {DW_BOUND}), "
            f"two launches identical: {torch.equal(got, again)}")
        if not torch.equal(got, again):
            raise AssertionError(f"phase10 {(b, h, w, ci, co, k)}: two launches differ")
        if not ratio <= DW_BOUND:
            raise AssertionError(f"phase10 {(b, h, w, ci, co, k)}: kernel and plain differ beyond the bound")
        if (h, w) == (HEIGHT, WIDTH):
            max_err = max(max_err, err)
            stem.append((x, dy, k))
    log(f"phase10 ok: worst error {worst:.3e} of sum|x*dy| ({time.time() - t0:.2f} s incl. the kernel build)")
    return max_err, stem


def train_cfg():
    """dd3d_kitti_dla34 with the stem's weight gradient on the kernel."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.PALLAS_STEM_DW = True
    return cfg


def build_train_model(cfg, device):
    """He-initialized convs from the seed (build_model's own init) and
    seeded norm statistics, so that features and gradients carry the image
    through the depth (randomize_state's N(0, 0.1) weights do not)."""
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.training.synthetic import seed_norm_statistics

    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    return seed_norm_statistics(model, torch.Generator().manual_seed(SEED + 1)).to(device)


def stem_convs(model):
    trunk = model.backbone.bottom_up
    return [trunk.base_layer, *trunk.level0]


def train_batches(cfg, n, batch, height, width, seed):
    from dd3d_tpu_torch.training.synthetic import synthetic_batch

    rng = np.random.RandomState(seed)
    return [synthetic_batch(rng, batch, height, width, max_gt=cfg.TPU.MAX_GT_PER_IMAGE,
                            num_classes=cfg.DD3D.NUM_CLASSES) for _ in range(n)]


def phase11_training(device):
    """TRAIN_STEPS steps of the train path through `train()`, with the dW
    kernel and then with its plain version, from the same start, with
    deterministic cuDNN algorithms. Returns the kernel's launch count."""
    from dd3d_tpu_torch.models.layers import FoldableBatchNorm, FrozenBatchNorm
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.training.train_loop import train

    cfg = train_cfg()
    batches = train_batches(cfg, TRAIN_STEPS, BATCH, HEIGHT, WIDTH, SEED + 7)
    n_gt = [int(b["gt_valid"].sum()) for b in batches]
    torch.backends.cudnn.deterministic = True
    runs = {}
    for mode in ("kernel", "plain"):
        t0 = time.time()
        model = build_train_model(cfg, device)
        for m in stem_convs(model):
            m.weight_grad_plain = mode == "plain"
        before = {k: v.clone() for k, v in model.state_dict().items()}
        metrics, dw_calls = [], []
        kernel = conv_dw.conv_dw_s1_same
        name = "conv_dw_s1_same" if mode == "kernel" else "conv_dw_s1_same_plain"
        real = getattr(conv_dw, name)

        def recording(fn):
            def wrapper(x, dy, k):
                out = fn(x, dy, k)
                if not metrics:  # step 1
                    dw_calls.append((x.clone(), dy.clone(), k, out.clone()))
                return out
            # conv_dw_s1_same counts its launches on the module's name for
            # itself, which is this wrapper while it stands in
            wrapper.launches = 0
            return wrapper

        setattr(conv_dw, name, recording(real))
        kernel.launches = 0
        try:
            train(cfg, batches, model=model, max_iter=TRAIN_STEPS, log_period=1,
                  metric_hook=lambda it, m: metrics.append(m))
            torch.cuda.synchronize()
            launches = conv_dw.conv_dw_s1_same.launches
        finally:
            setattr(conv_dw, name, real)
        log(f"phase11 {mode} dW: {TRAIN_STEPS} steps of batch {BATCH} at {HEIGHT}x{WIDTH} bf16 "
            f"({n_gt} GT boxes), dW kernel launches {launches} ({time.time() - t0:.2f} s incl. first-call set-up)")
        for i, m in enumerate(metrics):
            log(f"phase11 {mode} step {i + 1}: total {m['total_loss']:.4f} grad_norm {m['grad_norm']:.3f} "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()) if k.startswith("loss_")))
            if m["loss_finite"] != 1.0 or not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"phase11 {mode} step {i + 1}: a metric is not finite: {m}")
        if len(metrics) != TRAIN_STEPS:
            raise AssertionError(f"phase11 {mode}: {len(metrics)} steps logged of {TRAIN_STEPS}")
        if launches != (2 * TRAIN_STEPS if mode == "kernel" else 0):
            raise AssertionError(f"phase11 {mode}: {launches} dW kernel launches")
        live = frozen = 0
        for name, mod in model.named_modules():
            if isinstance(mod, (FoldableBatchNorm, FrozenBatchNorm)):
                moved = not all(torch.equal(getattr(mod, b), before[f"{name}.{b}"])
                                for b in ("weight", "bias", "running_mean", "running_var"))
                if isinstance(mod, FrozenBatchNorm) and moved:
                    raise AssertionError(f"phase11 {mode}: FrozenBN {name} moved")
                if isinstance(mod, FoldableBatchNorm):
                    if any(torch.equal(getattr(mod, b), before[f"{name}.{b}"]) for b in ("running_mean", "running_var")):
                        raise AssertionError(f"phase11 {mode}: live BN {name} statistics did not move")
                    live += 1
                else:
                    frozen += 1
        log(f"phase11 {mode}: running statistics of all {live} FCOS2D tower BNs moved, "
            f"none of the {frozen} FrozenBNs' buffers")
        runs[mode] = (metrics, dw_calls, launches)
    torch.backends.cudnn.deterministic = False

    (m_k, calls_k, launches), (m_p, calls_p, _) = runs["kernel"], runs["plain"]
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(m_k, m_p) for k in b
                if k.startswith("loss_") or k == "total_loss")
    log(f"phase11 kernel vs plain dW: worst relative loss difference over {TRAIN_STEPS} steps {worst:.3e} (limit 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError("phase11: losses with the kernel and with the plain dW differ")
    if len(calls_k) != 2 or len(calls_p) != 2:
        raise AssertionError(f"phase11: step 1 ran {len(calls_k)} / {len(calls_p)} stem weight gradients, not 2")
    for (x, dy, k, dw_k), (xp, dyp, _, dw_p) in zip(calls_k, calls_p):
        same_inputs = torch.equal(x, xp) and torch.equal(dy, dyp)
        ratio = dw_error_ratio(dw_k, dw_p, x, dy, k)
        log(f"phase11 step-1 stem dW k={k} x {tuple(x.shape)}: kernel vs plain run {ratio:.3e} of sum|x*dy| "
            f"(limit {DW_BOUND}); identical x and dy in both runs: {same_inputs}")
        if not ratio <= DW_BOUND:
            raise AssertionError("phase11: step-1 stem gradients differ beyond the phase-10 bound")
    log("phase11 ok")
    return launches


def phase12_fp32_train(device):
    """One fp32 train step on the card (TF32 off, dW kernel in f32) against
    the CPU (plain dW) at 128x256, batch 2. Tolerance 1e-3 relative: losses
    each; gradients as one flat vector in L2 (each tensor is also reported);
    each updated parameter tensor against its largest magnitude. Both are
    f32, summed in other orders through ~60 layers."""
    from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
    from dd3d_tpu_torch.training.train_step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    batch = train_batches(cfg, 1, 2, 128, 256, SEED + 8)[0]
    t0 = time.time()
    out = {}
    for dev in ("cpu", device):
        state = create_train_state(cfg, build_train_model(cfg, "cpu"), dev)
        metrics = make_train_step(cfg, state.model, state.optimizer)(to_device(batch, dev))
        params = dict(state.model.named_parameters())
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.detach().cpu() for n, p in params.items()},
                         {n: p.detach().cpu() for n, p in params.items()})
    torch.cuda.synchronize()
    (m_c, g_c, p_c), (m_g, g_g, p_g) = out["cpu"], out[str(device)]
    loss_rel = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-12) for k in m_c if k != "loss_finite")
    flat_c = torch.cat([g.reshape(-1) for g in g_c.values()])
    flat_g = torch.cat([g_g[n].reshape(-1) for n in g_c])
    grad_rel = float((flat_g - flat_c).norm() / flat_c.norm())
    per_tensor = max(((g_g[n] - g).norm() / max(float(g.norm()), 1e-30), n) for n, g in g_c.items())
    param_rel = max(float((p_g[n] - p).abs().max()) / max(float(p.abs().max()), 1e-30) for n, p in p_c.items())
    log(f"phase12 fp32 train step, card vs CPU ({time.time() - t0:.2f} s): losses and metrics worst {loss_rel:.3e}, "
        f"flat gradient L2 {grad_rel:.3e}, worst tensor L2 {float(per_tensor[0]):.3e} ({per_tensor[1]}), "
        f"updated parameters {param_rel:.3e} (limits 1e-3)")
    if not (loss_rel <= 1e-3 and grad_rel <= 1e-3 and param_rel <= 1e-3):
        raise AssertionError("phase12: the fp32 train step on the card and on the CPU differ")


def step_breakdown(cfg, state, batches):
    """Host ms of the parts of a train step, each ended by a synchronize:
    the step of training/train_step.py cut at its seams."""
    from dd3d_tpu_torch.models.dd3d import dd3d_losses
    from dd3d_tpu_torch.models.layers import QuantSpec, quant_scope
    from dd3d_tpu_torch.ops.color_jitter import apply_color_jitter

    model, opt = state.model, state.optimizer
    parts = {"forward": [], "loss": [], "backward": [], "optimizer": []}
    for b in batches:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        with quant_scope(QuantSpec()):
            outputs = model(apply_color_jitter(b["image"], b["color_jitter"]))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total = sum(dd3d_losses(cfg, outputs, b, model.strides).values())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.zero_grad()
        total.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for i, k in enumerate(parts):
            parts[k].append((t[i + 1] - t[i]) * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def phase13_train_timing(device, stem_cases):
    """ms per train step (host clock around each step, synchronized) with
    the dW kernel and the plain dW in turns (kernel, plain, plain, kernel),
    peak memory and the device busy share of the kernel path, and the dW
    kernel against its plain version and cuDNN's bf16 wgrad at the two stem
    shapes (plain, kernel, kernel, plain)."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same, conv_dw_s1_same_plain
    from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
    from dd3d_tpu_torch.training.train_step import make_train_step

    cfg = train_cfg()
    state = create_train_state(cfg, build_train_model(cfg, "cpu"), device)
    batches = [to_device(b, device) for b in train_batches(cfg, 3, BATCH, HEIGHT, WIDTH, SEED + 9)]
    step = make_train_step(cfg, state.model, state.optimizer)
    stem = stem_convs(state.model)

    def run(plain, steps=8):
        for m in stem:
            m.weight_grad_plain = plain
        step(batches[0])
        torch.cuda.synchronize()
        times = []
        for i in range(steps):
            t0 = time.perf_counter()
            step(batches[i % len(batches)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    ms = {"kernel": [], "plain": []}
    peak = None
    for mode in ("kernel", "plain", "plain", "kernel"):
        if peak is None:
            torch.cuda.reset_peak_memory_stats()
        ms[mode].append(run(mode == "plain"))
        if peak is None:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for mode, (a, b) in ms.items():
        log(f"phase13 train step, {mode} dW: median {a:.2f} / {b:.2f} ms a step of batch {BATCH} at {HEIGHT}x{WIDTH} "
            f"bf16 = {BATCH / np.mean([a, b]) * 1e3:.2f} images/s (kernel, plain, plain, kernel)")
    log(f"phase13 peak memory allocated over the first run (kernel dW; model, optimizer state, 3 batches and "
        f"the step): {peak:.2f} GiB")

    for m in stem:
        m.weight_grad_plain = False
    parts = step_breakdown(cfg, state, batches)
    log("phase13 host clock of a kernel-path step by part (synchronized after each; medians of 3): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    device_us = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0), e.key)
                 for e in kernels]
    busy = sum(t for t, _ in device_us)
    launches = sum(e.count for e in kernels) / len(batches)
    log(f"phase13 profiled {len(batches)} steps: device time {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall = "
        f"busy share {busy / wall_us:.3f} (under the profiler); {launches:.0f} kernel launches a step, "
        f"{len(kernels)} kernel names")
    for t, name in sorted(device_us, reverse=True)[:15]:
        log(f"phase13   {t / 1e3 / len(batches):9.3f} ms/step  {name[:110]}")

    kernel_ms = {}
    for x, dy, k in stem_cases:
        co, ci = dy.shape[1], x.shape[1]
        kern = lambda: conv_dw_s1_same(x, dy, k)  # noqa: E731
        plain = lambda: conv_dw_s1_same_plain(x, dy, k)  # noqa: E731
        cudnn = lambda: torch.nn.grad.conv2d_weight(x, (co, ci, k, k), dy, padding=(k - 1) // 2)  # noqa: E731
        kern(), plain(), cudnn()
        p_a, k_a, c_a = cuda_ms(plain, 5), cuda_ms(kern, 20), cuda_ms(cudnn, 20)
        k_b, p_b, c_b = cuda_ms(kern, 20), cuda_ms(plain, 5), cuda_ms(cudnn, 20)
        flop = 2 * x.numel() * co * k * k
        # x and dy (bf16) read, dW (f32) written; bf16 products on the tensor cores
        bnd, by = bound_ms((x.numel() + dy.numel()) * x.element_size() + 4 * co * ci * k * k, flop, "bf16")
        kernel_ms[k] = ((k_a + k_b) / 2, (p_a + p_b) / 2, bnd, by, (c_a + c_b) / 2)
        log(f"phase13 dW x {tuple(x.shape)} k={k} -> CO={co} ({flop / 1e9:.1f} GFLOP): kernel {k_a:.4f} / {k_b:.4f} "
            f"ms ({flop / 1e9 / kernel_ms[k][0]:.1f} TFLOP/s), plain {p_a:.4f} / {p_b:.4f} ms, cuDNN bf16 wgrad "
            f"{c_a:.4f} / {c_b:.4f} ms; bound {bnd:.4f} ms by {by}, {bnd / kernel_ms[k][0]:.2f} of the kernel's time")
    return ms, peak, kernel_ms


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
    build_libraries("nms.cu", "quantize.cu", "int8_conv.cu", "conv_dw.cu")  # one nvcc each, all at once
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
    imgs_per_s, nms_t = phase5_timing(cfg, model, images, intrinsics, serving_nms)
    torch.cuda.synchronize()

    quant_err, quant_case = phase6_quantize(device)
    torch.cuda.synchronize()
    conv_err, sites, conv_cases, conv_case = phase7_int8_conv(model, images[0])
    torch.cuda.synchronize()
    cfg8, launches = phase8_int8_path(cfg, model, images, intrinsics, sites)
    torch.cuda.synchronize()
    serving, kernel_ms = phase9_int8_timing(cfg8, cfg, model, images, intrinsics, quant_case, conv_case)
    int8_conv_sites_timing(conv_cases, cfg8.TPU.QUANT_MIN_CH)
    del conv_cases
    torch.cuda.synchronize()

    dw_err, stem_cases = phase10_conv_dw(device)
    torch.cuda.synchronize()
    dw_launches = phase11_training(device)
    torch.cuda.synchronize()
    phase12_fp32_train(device)
    torch.cuda.synchronize()
    train_ms, train_peak, dw_ms = phase13_train_timing(device, stem_cases)
    torch.cuda.synchronize()

    int8_ips = BATCH / (np.mean([r[0] for r in serving["int8"]]) / 1e3)
    bf16_ips = BATCH / (np.mean([r[0] for r in serving["bf16"]]) / 1e3)
    log(f"timing on {card}: bf16 {imgs_per_s:.1f} images/s (phase 5); phase 9 in turns: static int8 "
        f"{int8_ips:.1f} images/s, bf16 {bf16_ips:.1f} images/s (batch {BATCH}, {HEIGHT}x{WIDTH}); "
        f"NMS kernel {nms_t[0]:.4f} ms vs plain {nms_t[1]:.4f} ms at {NMS_SHAPE}; NMS launches on the bf16 "
        f"path {bf16_nms_launches}")
    log(f"timing on {card}: train step at batch {BATCH}, {HEIGHT}x{WIDTH}, bf16: "
        f"{np.mean(train_ms['kernel']):.2f} ms with the dW kernel, {np.mean(train_ms['plain']):.2f} ms with the "
        f"plain dW; peak {train_peak:.2f} GiB; dW kernel {dw_ms[7][0]:.4f} ms vs plain {dw_ms[7][1]:.4f} ms and "
        f"cuDNN {dw_ms[7][4]:.4f} ms at the 7x7 stem conv, {dw_ms[3][0]:.4f} ms vs cuDNN {dw_ms[3][4]:.4f} ms at "
        f"level0")
    timed = {"greedy_nms": (*nms_t, None), "quantize_int8": kernel_ms["quantize_int8"],
             "int8_conv": kernel_ms["int8_conv"], "conv_dw_s1_same": dw_ms[7]}
    rows = [("greedy_nms", "dd3d_tpu_torch/csrc/nms.cu", "dd3d_tpu/ops/pallas_nms.py:40", launches["greedy_nms"],
             nms_err),
            ("quantize_int8", "dd3d_tpu_torch/csrc/quantize.cu", "scripts/bench_quantize_kernel.py:91",
             launches["quantize_int8"], quant_err),
            ("int8_conv", "dd3d_tpu_torch/csrc/int8_conv.cu", "dd3d_tpu/models/layers.py:246", launches["int8_conv"],
             conv_err),
            ("conv_dw_s1_same", "dd3d_tpu_torch/csrc/conv_dw.cu", "dd3d_tpu/ops/pallas_conv.py:58", dw_launches,
             dw_err)]
    kernels = []
    for name, source, replaces, n, err in rows:
        ms, plain_ms, bnd, by, library_ms = timed[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                        "library_ms": library_ms})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
