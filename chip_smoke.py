#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (dd3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two serving paths for the dd3d_kitti_dla34 experiment
(DLA-34 + FPN + FCOS2D/FCOS3D heads at full width, channels_last), bf16 and
bench.py's static int8 (QUANT_MIN_CH=32, QUANT_UNFOLDED), through
`build_model` -> [`prepare_static_scales`] -> `get_inference_fn` ->
`infer(images, intrinsics)`, its training path, through
`build_model` -> `train(cfg, batches, model)` with TPU.PALLAS_STEM_DW, with
seeded random weights and seeded synthetic batches, its training CLI
on image files (`python -m dd3d_tpu_torch.train` under torch.distributed.run
on the port's KITTI-format fixture), and its evaluation (EVAL_ONLY,
`inference_on_dataset`, the KITTI-3D and COCO-2D evaluators, the R40 engine;
the overfit run trained and scored), its test-time augmentation and its
drawings, then the same paths of dd3d_kitti_v99 (VoVNet V-99-eSE + FPN
P3-P6: serving in bf16 and static int8, the train step, the CLIs), then
dd3d_nusc_dla34 (NuscenesDD3D: serving with the rotated BEV NMS and the
6-camera sample aggregation, EVAL_ONLY with the nuScenes evaluator and the
TTA test, training), then NMS past N = 2048, dd3d_kitti_regnety_006_bifpn
(RegNetY-006 + BiFPN: serving in bf16 and static int8 with the grouped int8
conv, the train step, the CLIs) and DD3DDenseDepth's train step, then both
nuScenes experiments in static int8 (serving with the aggregation, and
EVAL_ONLY with the TTA test at the experiment's five sizes), the nine other
DLA variants, DLA-X-60 in static int8 (its grouped convs on the `narrow`
and `mma` routes) and training, and DLA-34 with the FCOS2D v1 towers and
the per-level, class-agnostic 3D predictors, then JPEG frames (the port's
own decoder) through the nuScenes loader and serving, the train step
and CLI under TPU.REMAT, and the image kinds past 8-bit RGB PNGs and
Huffman JPEGs (gAMA,
palette, Adam7 and 16-bit PNGs; arithmetic, smoothed progressive, cut and
CMYK JPEGs) through the KITTI loader and serving, then the
quantize kernel on every bf16 value and the int8 conv's s8 epilogue at
every head-tower shape, and fails loudly (non-zero exit) if any phase fails.
In static int8 the head towers' links run fused (the next conv's quantize
in the int8 conv's s8 epilogue); phases 9, 22 and 31 serve each backbone
with the links fused and unfused in turns. The four CUDA sources (nms.cu
holds the NMS mask, the one-warp and the block scan and the BEV NMS's
pack; int8_conv.cu the int8 conv, with its s8 epilogue, and the grouped
one's four routes) and the host code (csrc/imageio.cpp,
csrc/kitti_eval.cpp with OpenMP, g++) are built first, one compiler
process each, all at once. The child processes of phases 14 to 32 (the
training CLIs, EVAL_ONLY, the overfit run, predict, calibrate_int8 and the
drawings) then start at once, beside phases 1-4, 6-8 and 10-12, which time
nothing; phases 5, 9 and 13 time after the children are done, and the
children's checks run in phase order after those.

1. hold the greedy-NMS CUDA kernels' keep masks (dd3d_tpu_torch/csrc/nms.cu)
   against the plain PyTorch version on the card, exactly, at N from 1 to
   2048 and on the edge cases of tests/test_torch_cuda.py;
2. serve 4 batches of 8 uint8 384x1280 images with KITTI intrinsics, and
   check the NMS input, the kernel's launch count, shapes and finiteness;
   the NMS inputs of the first batch are kept for phase 5;
3. decode the same batch with the plain suppression on the card: the
   detections must be identical;
4. fp32 on the card (TF32 off) against fp32 on the CPU, on a small batch;
5. timing: images/s of phase 2, and the NMS kernels' device time a call
   (profiler) and CUDA-event time against the plain version and the bound
   from the IoU tests that this data needs, on random boxes and on phase
   2's serving inputs;
6. the int8 quantize kernel (csrc/quantize.cu) against its plain version,
   exactly: the serving shape, ragged shapes, .5 ties, the clip, dynamic and
   static scales;
7. the int8 conv kernel (csrc/int8_conv.cu) against its plain version at
   every conv shape the int8 path reaches at 384x1280 (the stem's too):
   int32 accumulators exactly, bf16 and f32 epilogues bit for bit;
8. the static-int8 path: calibrate on 2 batches, serve 4 batches of 8, check
   the launch counts of all three kernels (one quantize fewer and one s8
   int8 conv for each fused tower link, counted from the model's
   structure: 60 a forward) and that no scale missed; the plain int8
   versions give identical detections; drift against bf16 is bounded as in
   tests/test_int8_infer.py;
9. timing: images/s of int8 and bf16 in turns, each int8 kernel against
   its plain version and its bound at a serving shape, and the int8 conv
   kernel beside cuDNN's bf16 conv and its bound at every shape of phase 7,
   summed as count x ms a forward; the tower links fused and unfused
   (`no_fusion`) in turns: identical detections on every batch, launches a
   forward of the quantize, of the int8 conv by output kind and of the
   ReLU, device time a batch (profiler) and images/s; the quantize at the
   shape of each of the fused forward's 55 standalone launches beside
   `x.to(torch.int8)` (the same bytes) and the bound, summed;
10. the stem weight-gradient kernel (csrc/conv_dw.cu) against its plain
    version on seeded bf16 inputs at the two stem shapes of the train step,
    the TPU benchmark's two shapes, a ragged one, and the two stem shapes
    at the CLI's smallest and largest resize bucket (384x1024, 640x1920):
    within 1e-5 of sum|x*dy| of each output, and bit-identical over two
    launches;
11. training: 4 steps through `train()` at batch 8, 384x1280, bf16, with the
    stem's weight gradient on the kernel: finite losses, 2 launches a step,
    the FCOS2D BN statistics moved and no FrozenBN buffer; the same 4 steps
    with the plain dW give the same losses and step-1 stem gradients;
12. one fp32 train step on the card (TF32 off) against the CPU at 128x256:
    losses, gradients and updated parameters;
13. timing: ms per train step and images/s with the kernel and with the
    plain dW in turns, peak memory, device busy share, and the dW kernel
    against its plain version, cuDNN's bf16 wgrad and its bound at the stem
    shapes;
14. the training CLI on files: the port writes its KITTI-format fixture (8
    images, dd3d_tpu_torch/overfit_smoke.py) and `python -m
    torch.distributed.run --standalone --nproc-per-node 1 -m
    dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit` trains 8
    steps of batch 8 from it (NCCL, DDP, global SyncBN, the loader's resize
    buckets, TPU.PALLAS_STEM_DW): exit 0, finite losses in metrics.jsonl, at
    least two resize buckets, 2 dW launches a step counted in that process,
    checkpoints at steps 4 and 8; then `train()` resumes from the run's
    directory at step 8 for 2 more steps;
15. timing: the train loader alone in images/s (thread path and process
    pool), and the CLI's median step time with the loader against the same
    steps on synthetic batches at the same resize bucket, in one process;
16. evaluation: `python -m dd3d_tpu_torch.train +experiments=
    dd3d_kitti_dla34_overfit EVAL_ONLY=True MODEL.CKPT=<phase 14's ckpt>
    TEST.AUG.ENABLED=False DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0` under
    torch.distributed.run (the checkpoint's scores lie below the default
    0.05; at 0 every image keeps its 100 detections) writes
    kitti_predictions.json and logs the kitti_3d/... and COCO results, with
    at least one NMS kernel launch a batch; then, in this process on the
    same loader's batches, `inference_on_dataset` through the NMS kernel and
    with the plain suppression gives identical per-image detections and
    results dicts;
17. the overfit run: `python -m dd3d_tpu_torch.overfit_smoke --iters 400
    --n-images 8 --int8-ab` (TPU.PALLAS_STEM_DW) trains batch 4 at
    384x1280 and scores itself: finite AP, the Car Moderate AP3D and BEV at
    0.5, ms a step, the int8 arm's worst |dAP|, and each arm's kernel
    launches (the int8 arm must launch the quantize and int8 conv kernels,
    both evaluations NMS, the training the dW kernel twice a step). No
    minimum AP is gated: two runs (45.05 each) are too few to set a floor,
    and the AP is still climbing here (0.00 after 200 steps);
18. evaluation at the size of a test set: phase 17's trained checkpoint
    over an 80-frame fixture (its first 8 frames are the training set), 20
    batches of 4 at 384x1280: the loader alone, then
    `inference_on_dataset` through the NMS kernel and with the plain suppression, which must give
    identical per-image detections and results dicts; eval images/s
    (loader, forward, decode, evaluators), each evaluator's host seconds and
    the R40 engine's;
19. the visualizers, on a machine without cv2: the training CLI with the
    experiment's own TEST.AUG and VIS (4 steps under TPU.REMAT=full, read
    by phase 43; the dataloader period at 2) draws the dataloader (each
    drawing differs from its undrawn batch image at every ground-truth
    box) and, in its final test (plain, then TTA, both in metrics.jsonl),
    the predictions; `predict --vis` with the
    overfit checkpoint and `python -m dd3d_tpu_torch.visualize_dataloader`
    write theirs, each read back with the port's PNG reader and checked
    for its shape and its drawn boxes;
20. test-time augmentation at full width on the overfit checkpoint over a
    32-frame fixture, one chunk at TEST.IMS_PER_BATCH 80, five scales with
    flip in five canvas buckets of 64 instances, 384x1152 to 640x1920:
    (a) EVAL_ONLY through the CLI's main, bf16: the plain test, then the
    TTA test (images/s, buckets, host seconds by part, peak memory,
    launches, tta/ AP beside the plain AP; its prediction drawings drawn
    at the cars); (b) the TTA test in static int8 (bench.py's overrides,
    each bucket calibrated on its first batch): no scale miss, the
    calibrated buckets, launches, images/s, worst |dAP| against bf16; (c)
    on 8 frames, int8 TTA through the kernels and through their plain
    versions: identical detections and results; the int8 conv kernel
    against its plain version at the largest bucket's P3 tower conv
    (timed beside cuDNN's bf16 conv and its bound) and at its level0 conv,
    whose 3.1e9-element input the wrapper launches in two runs;
21. dd3d_kitti_v99 (V-99-eSE + FPN 256 + P3-P6, full width and depth,
    randomize_state weights), bf16 serving of 4 batches of 8 at 384x1280:
    phase 2's checks, the NMS kernel against the plain suppression
    (identical detections), fp32 on the card against the CPU at batch 1
    (1e-3), images/s, ms a batch, the profiler's device time and launches
    a batch, peak memory;
22. its static int8 in scripts/bench_v99.py's settings (QUANT_MIN_CH 32,
    scales from 2 batches): phase 7 at every distinct int8 conv site of
    this path, the quantize kernel at stage 2's concat input, phase 8's
    path checks, int8 against bf16 in turns, the int8 sites summed
    against cuDNN's bf16 conv and the bound, and the tower links fused and
    unfused in turns as in phase 9 (36 links: the predictors stay bf16);
23. its bf16 train step at batch 8, 384x1280, on seeded synthetic batches:
    finite losses, ms a step over 8 timed steps, peak memory, launches;
24. its CLIs on the 8-frame fixture: `train` for 4 steps of batch 8
    (TPU.PALLAS_STEM_DW on: no dW launch on VoVNet), EVAL_ONLY from its
    checkpoint with the NMS kernel and the plain suppression in turns
    (identical), `predict` on a 375x1200 frame (a 384x1280 canvas, as JAX
    pads) and `calibrate_int8`;
25. dd3d_nusc_dla34 (NuscenesDD3D: DLA-34, FPN 256, 10 classes, attribute
    and speed heads; randomize_state weights) bf16 serving at full width:
    3 batches of 12 synthetic 900x1600 frames resized by MIN_SIZE_TEST 896
    onto 896x1664 canvases, two samples of 6 cameras a batch (a sample's
    cameras one frame under one pose), with DO_BEV_NMS and
    NUSC_SAMPLE_AGGREGATE: shapes, finiteness, each sample's detections
    cut by the aggregation (against each camera alone), global
    translations in front of the pose; launches on the main path, one NMS
    and two BEV scans (the per-image BEV NMS at (12, 100), the samples' at
    (2, 600)) a batch; the kernel path against the plain suppression and
    `greedy_suppress`: identical detections, the scan's keep masks equal;
    images/s, device time and launches a batch (profiler), busy share,
    peak memory; the scan's device time at both shapes against the plain
    `greedy_suppress` and its bound; one batch of dd3d_nusc_v99 served the
    same way, finite;
26. fp32 on the card (TF32 off) against the CPU for NuscenesDD3D's ten head
    outputs (attr_logits and speed included) at batch 1, 256x448 (1e-3);
27. the CLI's EVAL_ONLY on a 6-camera JSON-manifest fixture (8 samples, 48
    PNGs at 900x1600, a car each, `overfit_smoke.make_nusc_fixture`) in
    this process: the plain test (nuscenes_evaluator, the aggregation on
    the card) and the TTA test (NuscenesDD3DWithTTA, TEST.AUG.MIN_SIZES
    cut to [640, 896] with flip, the BEV NMS over each merge, the host
    aggregation): finite NDS and mAP, both submissions' translations the
    fixture's pose plus a camera-frame one, launches, images/s, the
    evaluator's and the TTA pass's seconds by part;
28. the training CLI (`+experiments=dd3d_nusc_dla34` on the same fixture)
    under torch.distributed.run: 4 steps of batch 8 at the 896 bucket
    (896x1664), TPU.PALLAS_STEM_DW: finite losses, loss_attr and
    loss_speed finite and non-zero, the dW kernel twice a step; ms a step
    and peak memory;
29. the NMS kernels past N = 2048 (the block scan): keep masks equal to the
    plain versions at (B, N) = (2, 4096), (8, 5000) and (1, 10000) and the
    BEV scan at (2, 4096), device times against the plain ones; then
    dd3d_kitti_dla34 bf16 serving with the reference's 1000 candidates a
    level and no cap (TPU.PRE_NMS_CANDIDATES_PER_LEVEL 1000,
    TPU.NMS_CANDIDATES 0), kernel and plain detections identical;
30. dd3d_kitti_regnety_006_bifpn (RegNetY-006 + BiFPN 160 x 3, P3-P7, full
    width and depth, randomize_state weights) bf16 serving of 4 batches of
    8 at 384x1280: phase 2's and 3's checks, fp32 on the card against the
    CPU at batch 1 (1e-3), images/s, device time and launches a batch,
    busy share, peak memory;
31. its static int8 in bench.py's settings (QUANT_MIN_CH 32,
    QUANT_UNFOLDED): phase 7 at every ungrouped int8 site, the grouped
    int8 conv kernels (csrc/int8_conv.cu) at every grouped site (RegNet's
    Y-block `b` on the `mma` route, BiFPN's depthwise `dw` on the
    `depthwise` route; 39 a forward): every route a shape admits (its own
    and `direct`) bit for bit against the plain version, timed in turns
    with cuDNN's bf16 grouped conv (direct, own, cuDNN, cuDNN, own, direct,
    twice) beside the bound, summed over a forward; phase 8's path checks with the grouped
    launches by route; int8 against bf16 in turns; the int8 batch's device
    time with every grouped conv on `direct` and on its own route in
    turns; the tower links fused and unfused in turns as in phase 9; then
    `predict` in bf16, `calibrate_int8` and `predict` in static int8 on a
    375x1200 frame;
32. its bf16 train step at batch 8, 384x1280 (ms a step, peak memory,
    launches, busy share), then the training CLI for 2 steps on the
    8-frame fixture and EVAL_ONLY from its checkpoint (KITTI-3D and
    COCO-2D evaluators);
33. DD3DDenseDepth (depth pretraining, the DLA-34 trunk,
    TPU.PALLAS_STEM_DW) bf16 train steps at batch 8, 384x1280 on seeded
    synthetic batches with sparse GT depth through make_train_step: finite
    losses, parameters moving, the dW kernel twice a step, ms a step, peak
    memory, busy share;
34. the quantize kernel (division-free, csrc/quantize.cuh) against its
    plain version on all 65,282 non-NaN bf16 values at 20 scales, as bf16
    and f32 input, through both packet widths, and on ragged and unaligned
    tensors (tests/test_torch_cuda.py's checks, loaded by path);
35. the int8 conv's s8 epilogue against `int8_conv_requant_plain`, bit for
    bit, at every head-tower shape of DLA-34, V2-99 and RegNetY + BiFPN and
    a ragged M (the same file's check); at the P3 tower conv the device time
    of the s8 epilogue (at a calibrated and at a round scale), the bf16 one
    and the unfused link, in turns, beside the plain version, cuDNN and the
    bound;
36. dd3d_nusc_dla34 in bench.py's static int8 (QUANT_MIN_CH 32,
    QUANT_UNFOLDED) at full width, batch 12 (two samples of 6 cameras),
    896x1664, randomize_state weights: phase 7 at every int8 conv shape of
    the path, the convs QUANT_MIN_CH 32 keeps in bf16, calibration on 2
    batches, 3 batches served with the sample aggregation counting the
    quantize, the int8 conv by output kind (55 fused tower links a forward:
    the cls tower's last link stays unfused, read by the cls predictor and
    the attribute/speed group), the NMS and the BEV scan, no scale miss;
    kernel and plain detections identical; int8 against bf16 within the
    drift bounds, the attribute logits' and speeds' drift beside them; ms
    and device time a batch of int8 and bf16 in turns; the int8 conv at
    its P3 tower conv (12, 112, 208, 256) with the s8 and the bf16
    epilogue, equal to the plain version, beside cuDNN and the bound; then
    dd3d_nusc_v99 in scripts/bench_v99.py's settings (QUANT_MIN_CH 32, the
    predictors bf16) the same way on one batch, untimed;
37. EVAL_ONLY of dd3d_nusc_dla34 in static int8 through `train.main` on a
    2-sample fixture (12 PNGs at 900x1600) with the experiment's own
    TEST.AUG (640-1152 with flip): the plain test (dynamic scales) and the
    TTA test, each canvas bucket calibrated on its first batch, no scale
    miss, finite NDS and mAP, launches; `batch_chunks`' runs at the
    1152x2048 bucket; the int8 conv at that bucket's P3 tower conv (24,
    144, 256, 256) as in phase 36;
38. the nine other DLA variants (Bottleneck, BottleneckX with cardinality
    32 and 64, residual roots) under dd3d_kitti_dla34's heads: one bf16
    batch of 8 at 384x1280 each, finite, the NMS kernel once;
39. DLA-X-60 in bench.py's static int8: phase 7 at every ungrouped site, the
    grouped kernel at each of its 8 grouped shapes (C/g = 4 and 8 on
    `narrow`, 16 and 32 on `mma`) and at DLA-X-60-C's C/g 2 and
    DLA-X-102-64's 64-group shapes on every route the shape admits, bit for
    bit, timed on both in turns with cuDNN's bf16 grouped conv (not gated)
    beside the bound; phase 8's path checks (narrow and mma launches both
    non-zero); the int8 batch's detections identical and its device time
    in turns with every grouped conv on `direct` and on its own route;
40. DLA-X-60's bf16 train step at batch 8, 384x1280, TPU.PALLAS_STEM_DW:
    finite losses, the dW kernel twice a step, ms a step;
41. DLA-34 with FCOS2D _VERSION v1, PER_LEVEL_PREDICTORS and
    CLASS_AGNOSTIC_BOX3D together: bf16 serving (phases 2 and 3's
    checks), bench.py's static int8 (phase 8's checks), and the tower links
    fused and unfused in turns (identical detections);
42. JPEG frames, decoded on the host by the port's own decoder
    (csrc/imageio.cpp): every committed fixture of tests/data/jpeg decodes
    to the SHA-256 of the JAX package's libjpeg decode; ms a frame of the
    900x1600 fixture on one thread; dd3d_nusc_dla34's test loader in
    images/s over 12 JPEG frames against the same pixels as PNGs, in turns;
    one bf16 batch of 12 (two samples of 6 cameras, 896x1664) served from a
    JSON manifest of the JPEGs and from one of the PNGs: identical
    canvases and detections, the NMS kernel once and the BEV scan twice;
43. TPU.REMAT: dd3d_kitti_dla34's bf16 train step at batch 8, 384x1280,
    TPU.PALLAS_STEM_DW, under "none", "full", "dots_saveable" and "none"
    again, each from the same seeded weights: under
    torch.use_deterministic_algorithms(True) the first step's losses,
    gradients, updated parameters and BN running stats equal "none"'s bit
    for bit; the dW kernel twice a step; ms a step and peak memory over 6
    more steps, one profiled step's device time; the training steps of
    phase 19's CLI, which trains under TPU.REMAT=full under
    torch.distributed.run (NCCL, world size 1): finite losses, the dW
    kernel twice a step;
44. the image kinds past 8-bit RGB PNGs and Huffman JPEGs, on a host
    without cv2, libpng or libjpeg: every fixture of tests/data/png and
    tests/data/jpeg decodes to the SHA-256 of the JAX package's
    read_image_bgr; ms a 375x1242 frame on one thread for each kind beside
    phase 42's baseline JPEG; dd3d_kitti_dla34's test loader serves one
    bf16 batch of 8 at 384x1280 from a KITTI fixture whose frames are a gAMA
    PNG, a palette Adam7 PNG, an Adam7 PNG, a 16-bit PNG, an
    arithmetic-coded JPEG, a smoothed progressive JPEG, a JPEG cut inside a
    marker segment and a CMYK JPEG, and from the same pixels as plain PNGs:
    identical canvases and detections, the NMS kernel once, and identical
    detections with the plain suppression;
45. DLA's stem convs on the stem kernel (ops/stem_conv.py): DLA-34's
    folded weights chained from uint8 frames, at 128 frames of 384x1280
    and 12 of 896x1664, each output against stem_conv_plain within 2 bf16
    ulps, none beyond the bound, at least 99.9 % equal bit for bit; device
    time of the three kernels, the plain version and cuDNN + bias + ReLU at
    128x384x1280; 3 kernel launches a served forward in bf16 and in static
    int8.

The training runs of phases 17, 19, 24, 28 and 32 run the train loader
on its thread path (phase 15 times the process pool against it), so that
none spawns a pool of its own.

Before the last line, the card's name and power limit and one JSON line of
the nine kernel entries (the greedy NMS, the BEV NMS's scan, quantize,
int8 conv, the int8 conv with the s8 epilogue, grouped int8 conv on its
depthwise, mma and direct routes, on its narrow route, dW, the stem conv): launches on the main paths
(DLA-34's, V2-99's, nuScenes' in bf16 and int8, RegNetY's, DenseDepth's, the DLA variants', DLA-X-60's,
the head options', the JPEG-served batch's and the REMAT steps'; the stem conv's on phase 45's bf16 and
static-int8 serving), error against the plain
version, ms, the plain version's ms, the bound (bytes or operations at the
published H100 peaks) and, where one PyTorch call computes the same thing,
that call's ms.

Needs one CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); no network.
The last line printed is {"ok": true, "device": {...}}.

`chip_smoke.py --cli-rank ARGS`, `--cli-timing ARGS`, `--eval-only ARGS` and
`--vis-rank ARGS` are phases 14, 15, 16 and 19's CLIs, each inside the
process that torch.distributed.run starts; they are not run by hand.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
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


_START = time.time()


def log(msg):
    """One line of the run's log, after the seconds since the script started."""
    print(f"[{time.time() - _START:7.1f} s] {msg}", flush=True)


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
        getattr(model, "base", model).fcos2d_head.box2d_reg.bias += 4.0  # NuscenesDD3D holds DD3D as `base`


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


def card_tests():
    """tests/test_torch_cuda.py of this checkout, loaded by its path (an
    installed package may also be named `tests`)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_cuda.py")
    spec = importlib.util.spec_from_file_location("card_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


NMS_SIZES = (1, 63, 64, 65, 300, 2048)  # N of the extra random cases: the word edges, ragged, the maximum
NMS_EDGE_SIZES = (65, 300, 2048)
NMS_SWEEP = (64, 128, 256, 512, 1024, 2048)  # N of phase 5's device-time sweep, at batch BATCH


def phase1_kernel(device):
    """Kernel vs plain keep masks on the card: random boxes at the serving
    shape and at every N of NMS_SIZES, and the edge cases of the card tests
    (tests/test_torch_cuda.py::nms_edge_case: ties at the threshold, chains
    across words, invalid boxes in a chain, identical and zero-area boxes,
    nothing valid), which must also give their known keep masks. Returns
    (max_abs_err, (boxes, valid)) at the serving shape."""
    from dd3d_tpu_torch.ops.nms import batched_nms_padded
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    cases_module = card_tests()
    NMS_EDGE_CASES, nms_edge_case = cases_module.NMS_EDGE_CASES, cases_module.nms_edge_case

    gen = torch.Generator().manual_seed(SEED)
    t0 = time.time()
    cases = []
    b, n = NMS_SHAPE
    serving = random_sorted_boxes(gen, b, n, device)
    for thr in (0.75, 0.5):
        cases.append((f"random B={b} N={n} thr={thr}", serving[0], serving[1], thr, None))
    for size in NMS_SIZES:
        boxes, valid = random_sorted_boxes(gen, 3, size, device)
        cases.append((f"random B=3 N={size} thr=0.6", boxes, valid, 0.6, None))
    for name in NMS_EDGE_CASES:
        for size in NMS_EDGE_SIZES:
            boxes, valid, want = nms_edge_case(name, size)
            cases.append((f"{name} B=2 N={size} thr=0.5", torch.from_numpy(boxes).to(device),
                          torch.from_numpy(valid).to(device), 0.5, torch.from_numpy(want).to(device)))

    max_err = 0
    for name, bx, vd, thr, want in cases:
        keep_k = greedy_nms(bx, vd, thr)
        torch.cuda.synchronize()
        keep_p = greedy_nms_plain(bx, vd, thr)
        err = int((keep_k.int() - keep_p.int()).abs().max())
        max_err = max(max_err, err)
        log(f"phase1 {name}: kept {int(keep_k.sum())}/{int(vd.sum())} valid, "
            f"max |kernel - plain| = {err} (tolerance 0: keep masks must be equal)")
        if err:
            raise AssertionError(f"phase1 {name}: kernel and plain keep masks differ")
        if want is not None and not torch.equal(keep_k, want):
            raise AssertionError(f"phase1 {name}: the keep mask is not the greedy walk's known answer")

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


def phase2_serve(cfg, model, images, intrinsics, phase="phase2"):
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    candidates, survivors, inputs = [], [], []

    def counting_suppress(boxes, valid, thr):
        keep = greedy_nms(boxes, valid, thr)
        candidates.append(valid.sum(dim=1).cpu())
        survivors.append(keep.sum(dim=1).cpu())
        inputs.append((boxes.clone(), valid.clone()))
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
                raise AssertionError(f"{phase} batch {i}: {k} has shape {tuple(v.shape)}")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"{phase} batch {i}: {k} is not finite")
        log(f"{phase} batch {i}: valid NMS candidates per image {candidates[i].tolist()}, "
            f"surviving suppression {survivors[i].tolist()}, detections {det['valid'].sum(dim=1).tolist()}")
        if int(candidates[i].min()) < 100:
            raise AssertionError(f"{phase}: fewer than 100 valid NMS candidates in an image")
    if launches < N_BATCHES:
        raise AssertionError(f"{phase}: NMS kernel launched {launches} times for {N_BATCHES} batches")
    if all(torch.equal(c, k) for c, k in zip(candidates, survivors)):
        raise AssertionError(f"{phase}: NMS suppressed nothing; the check would be trivial")
    log(f"{phase} ok: {N_BATCHES} batches of {BATCH} at {HEIGHT}x{WIDTH}, NMS kernel launches {launches} "
        f"({time.time() - t0:.2f} s incl. first-call set-up)")
    return launches, inputs[0]


def phase3_plain_path(cfg, model, images, intrinsics, phase="phase3"):
    from dd3d_tpu_torch.models.dd3d import dd3d_inference
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_plain

    with torch.inference_mode():
        outputs = model(images[0])
        det_k = dd3d_inference(cfg, outputs, intrinsics, model.strides)
        det_p = dd3d_inference(cfg, outputs, intrinsics, model.strides, suppress=greedy_nms_plain)
    torch.cuda.synchronize()
    for k in det_k:
        if not torch.equal(det_k[k], det_p[k]):
            raise AssertionError(f"{phase}: {k} differs between the kernel path and the plain path")
    log(f"{phase} ok: kernel-path and plain-path detections identical ({int(det_k['valid'].sum())} kept)")


def phase4_fp32(cfg, device, shape=(2, 128, 384), phase="phase4"):
    """Tolerance: both sides are fp32, summed in other orders by cuDNN and by
    the CPU's convolutions (a few ulps per layer over ~40 layers), so each
    head output must agree to 1e-3 of its own largest magnitude."""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_model = build(cfg, "cpu")
    gpu_model = build(cfg, device)
    rng = np.random.RandomState(SEED + 2)
    images = torch.from_numpy(rng.randint(0, 256, (*shape, 3), dtype=np.uint8))
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
                raise AssertionError(f"{phase}: {k} level {lvl}: max |card - cpu| = {err} ({rel:.2e} relative)")
    log(f"{phase} ok: fp32 card vs CPU head outputs, worst relative error {worst:.3e} (limit 1e-3)")


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


def nms_times(bx, vd, thr, prof):
    """(profiler device ms a call, summed over both kernels; CUDA-event ms a
    call over 200 calls, which time the wrapper's host side when it is the
    slower; plain CUDA-event ms), in turns: plain, kernel, kernel, plain."""
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    for _ in range(3):
        greedy_nms(bx, vd, thr)
        greedy_nms_plain(bx, vd, thr)
    plain_a = cuda_ms(lambda: greedy_nms_plain(bx, vd, thr), 20)
    dev_a = device_ms(lambda: greedy_nms(bx, vd, thr), 50, prof)
    ev_a = cuda_ms(lambda: greedy_nms(bx, vd, thr), 200)
    ev_b = cuda_ms(lambda: greedy_nms(bx, vd, thr), 200)
    dev_b = device_ms(lambda: greedy_nms(bx, vd, thr), 50, prof)
    plain_b = cuda_ms(lambda: greedy_nms_plain(bx, vd, thr), 20)
    return (dev_a, dev_b), (ev_a, ev_b), (plain_a, plain_b)


def phase5_timing(cfg, model, images, intrinsics, nms_inputs):
    """Serving images/s, and the NMS kernels on each of `nms_inputs` ({name:
    (boxes, valid)}): device time (profiler) and CUDA-event time against the
    plain version, the bound from the IoU tests the greedy walk needs on
    that data, and the pairs the mask kernel tests (every j > i). Returns
    (images/s, {name: (device ms, plain ms, bound ms, bound_by)})."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    med, p25, p75 = serving_ms(get_inference_fn(model, cfg), images, intrinsics)
    log(f"phase5 serving: batch {BATCH} {HEIGHT}x{WIDTH} bf16, median {med:.3f} ms/batch over "
        f"{3 * len(images)} batches (p25 {p25:.3f}, p75 {p75:.3f}) = {BATCH / med * 1e3:.1f} images/s, "
        f"input already on the card")

    thr = cfg.DD3D.FCOS2D.INFERENCE.NMS_THRESH
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    out = {}
    for name, (bx, vd) in nms_inputs.items():
        dev, ev, plain = nms_times(bx, vd, thr, prof)
        dev_ms, plain_ms = float(np.mean(dev)), float(np.mean(plain))
        bound, bound_by, pairs, keep = nms_bound(bx, vd, thr)
        if not torch.equal(keep, greedy_nms(bx, vd, thr).cpu()):
            raise AssertionError(f"phase5 {name}: the pair-counting walk and the kernel keep different boxes")
        b, n = vd.shape
        log(f"phase5 nms {name} (B, N) = ({b}, {n}), thr {thr}: kernels' device time {dev[0]:.4f} / {dev[1]:.4f} "
            f"ms a call (profiler, mask + scan), CUDA events {ev[0]:.4f} / {ev[1]:.4f} ms a call, plain "
            f"{plain[0]:.4f} / {plain[1]:.4f} ms (plain, kernel, kernel, plain); {pairs} IoU tests on this data: "
            f"bound {bound:.6f} ms by {bound_by} ({bound / dev_ms:.2e} of the device time); the mask kernel "
            f"tests all {b * n * (n - 1) // 2} pairs j > i; the scan's serial chain of {n} rows an image is a "
            f"latency floor that no roofline counts")
        out[name] = (dev_ms, plain_ms, bound, bound_by)

    # how each kernel's device time grows with N: the mask with the pairs
    # (N^2 / 2), the scan with the rows of its serial chain (N)
    gen = torch.Generator().manual_seed(SEED + 10)
    for n in NMS_SWEEP:
        bx, vd = random_sorted_boxes(gen, BATCH, n, bx.device)
        by_kernel = device_ms_by_kernel(lambda: greedy_nms(bx, vd, thr), 50, prof)
        log(f"phase5 nms sweep (B, N) = ({BATCH}, {n}): device time a call " + ", ".join(
            f"{k.split('::')[-1].split('(')[0]} {v * 1e3:.2f} us" for k, v in sorted(by_kernel.items())))
    return BATCH / med * 1e3, out


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


def int8_conv_sites(model, images, unfolded=True, grouped=None):
    """Every distinct int8 conv the static-int8 path reaches on `images`, as
    {(B, H, W, C, O, k, stride): count per forward}: one forward with every
    eligible conv quantized (QUANT_MIN_CH=0, the calibration regime, which
    adds the stem and the 16-channel convs to the serving set) and, with
    `unfolded` (QUANT_UNFOLDED), the predictors too, recording the shapes
    that reach int8_conv_dequant. Grouped convs (the grouped kernel's) go
    into the dict `grouped` instead, keyed (B, H, W, C, O, k, stride,
    groups)."""
    import dd3d_tpu_torch.models.layers as L

    sites, grouped = {}, {} if grouped is None else grouped
    real = L.int8_conv_dequant

    def record(x, weight, bias, stride, pad, out_dtype, act_amax=None, plain=False, groups=1, **kwargs):
        key = (x.shape[0], x.shape[2], x.shape[3], x.shape[1], weight.shape[0], weight.shape[2], stride)
        into = sites if groups == 1 else grouped
        key = key if groups == 1 else key + (groups,)
        into[key] = into.get(key, 0) + 1
        return real(x, weight, bias, stride, pad, out_dtype, act_amax, plain, groups, **kwargs)

    L.int8_conv_dequant = record
    try:
        with torch.inference_mode(), L.quant_scope(L.QuantSpec(enabled=True, min_ch=0, unfolded=unfolded,
                                                                plain=True)):
            model(images)
    finally:
        L.int8_conv_dequant = real
    return sites


def phase7_int8_conv(model, images, unfolded=True, phase="phase7"):
    """int8_conv kernel vs plain on the card at every conv shape of the int8
    path at the serving size: int32 accumulators exactly (scale 1, f32 out,
    every |acc| below 2^24 so f32 holds it exactly) and the dequant epilogue
    bit for bit (bf16 out with bias, and f32 out with bias). Returns
    (max_abs_err, sites, [(site, count, (xq, wq, scale, bias, stride, pad))],
    the P3 tower-conv case for timing)."""
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv, int8_conv_acc_plain

    t0 = time.time()
    sites = int8_conv_sites(model, images, unfolded)
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
            raise AssertionError(f"{phase}: accumulators beyond 2^24 would not be checked exactly in f32")
        ones = torch.ones(o, device=device)
        checks = [("acc", int8_conv(xq, wq, ones, None, stride, pad, torch.float32), acc.float())]
        for dt in (torch.bfloat16, torch.float32):
            got = int8_conv(xq, wq, scale, bias, stride, pad, dt)
            checks.append((str(dt), got, dequant_plain(acc, scale, bias, dt)))
        torch.cuda.synchronize()
        errs = []
        for name, got, want in checks:
            if got.shape != want.shape:
                raise AssertionError(f"{phase} {name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            errs.append(float((got.float() - want.float()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"{phase} (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} {name}: "
                                     f"kernel and plain differ, max |diff| = {errs[-1]}")
        max_err = max(max_err, *errs)
        log(f"{phase} (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} x{count}/forward: accumulators, "
            f"bf16 and f32 epilogues equal (tolerance 0)")
        cases.append(((b, h, w, c, o, k, stride), count, (xq, wq, scale, bias, stride, pad)))
        if (c, o, k, h) == (256, 256, 3, HEIGHT // 8):  # a tower conv at P3
            timing_case = cases[-1][2]
    log(f"{phase} ok: {len(sites)} conv shapes, {sum(sites.values())} int8 convs a forward "
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


def fused_links_per_forward(model, cfg) -> int:
    """The head-tower links whose quantize runs in the int8 conv's s8
    epilogue in one static-int8 forward, from the model's structure alone:
    each tower conv's output is read by one conv, the next tower conv or,
    after the last, the predictors (int8 only under QUANT_UNFOLDED), at
    every level, where the tower is at least QUANT_MIN_CH wide."""
    links = 0
    for head, towers in ((model.fcos2d_head, ("cls_tower", "box2d_tower")), (model.fcos3d_head, ("box3d_tower",))):
        for name in towers:
            tower = getattr(head, name)
            if tower[0].weight.shape[1] >= cfg.TPU.QUANT_MIN_CH:
                per_level = len(tower) - 1 + int(bool(cfg.TPU.QUANT_UNFOLDED))
                links += per_level * len(tower[0].norm)
    return links


def phase8_int8_path(bf16_cfg, model, images, intrinsics, sites, base_cfg=None, phase="phase8", grouped=None):
    """The static-int8 serving path: calibrate on 2 batches with
    prepare_static_scales, serve N_BATCHES batches through get_inference_fn,
    check every kernel's launch count (the grouped kernel's at the `grouped`
    sites; the int8 conv's by output kind: one s8 launch and one quantize
    fewer for each fused tower link) and that no scale missed; the same
    batch through the plain int8 versions and the plain NMS gives identical
    detections; drift against bf16 within the bounds of
    tests/test_int8_infer.py:116-121. Returns (cfg, launches by kernel)."""
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.int8_conv import grouped_route, int8_conv, int8_conv_grouped
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    t0 = time.time()
    cfg = prepare_static_scales(base_cfg or int8_cfg(), model, images[:2], tag="chip_smoke")
    torch.cuda.synchronize()
    log(f"{phase} calibrated on 2 batches of {BATCH} ({time.time() - t0:.2f} s)")
    min_ch = cfg.TPU.QUANT_MIN_CH
    per_forward = sum(n for (_, _, _, c, _, _, _), n in sites.items() if c >= min_ch)
    grouped_per_forward = sum(n for key, n in (grouped or {}).items() if key[3] >= min_ch)

    fused = fused_links_per_forward(model, cfg)
    infer = get_inference_fn(model, cfg)
    kernels = (quantize_int8, int8_conv, int8_conv_grouped, greedy_nms)
    for k in kernels:
        k.launches = 0
    int8_conv_grouped.launches_by_route.update(dict.fromkeys(int8_conv_grouped.launches_by_route, 0))
    int8_conv.launches_by_out.update(dict.fromkeys(int8_conv.launches_by_out, 0))
    dets = [infer(im, intrinsics) for im in images]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    by_route, by_out = dict(int8_conv_grouped.launches_by_route), dict(int8_conv.launches_by_out)
    log(f"{phase} served {N_BATCHES} batches of {BATCH} at {HEIGHT}x{WIDTH}, static int8: launches {launches}, "
        f"int8 conv by output kind {by_out}, grouped by route {by_route}, {per_forward} quantized convs a forward "
        f"and {grouped_per_forward} grouped ones, {fused} fused tower links a forward")
    expected = per_forward * N_BATCHES
    expected_grouped = grouped_per_forward * N_BATCHES
    expected_quantize = expected + expected_grouped - fused * N_BATCHES
    if (launches["quantize_int8"] != expected_quantize or launches["int8_conv"] != expected
            or launches["int8_conv_grouped"] != expected_grouped):
        raise AssertionError(f"{phase}: expected {expected_quantize} quantize, {expected} int8 conv and "
                             f"{expected_grouped} grouped int8 conv launches, got {launches}")
    if by_out != {"f32": 0, "bf16": expected - fused * N_BATCHES, "s8": fused * N_BATCHES}:
        raise AssertionError(f"{phase}: int8 conv launches by output kind {by_out}, expected "
                             f"{expected - fused * N_BATCHES} bf16 and {fused * N_BATCHES} s8")
    launches["int8_conv_by_out"] = by_out
    launches["fused_links_per_forward"] = fused
    launches["quantize_per_forward"] = {"fused": expected_quantize // N_BATCHES,
                                        "unfused": (expected + expected_grouped) // N_BATCHES}
    expected_by_route = dict.fromkeys(by_route, 0)
    for (_, _, _, c, o, k, stride, g), n in (grouped or {}).items():
        if c >= min_ch:
            expected_by_route[grouped_route(c, o, k, k, stride, g)] += n * N_BATCHES
    if by_route != expected_by_route:
        raise AssertionError(f"{phase}: expected grouped launches by route {expected_by_route}, got {by_route}")
    launches["int8_conv_grouped_by_route"] = by_route
    if launches["greedy_nms"] != N_BATCHES:
        raise AssertionError(f"{phase}: NMS kernel launched {launches['greedy_nms']} times for {N_BATCHES} batches")
    if infer.quant.misses:
        raise AssertionError(f"{phase}: static scales missed {infer.quant.misses[:5]}")
    d = cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
    for i, det in enumerate(dets):
        for k, v in det.items():
            if v.shape[:2] != (BATCH, d):
                raise AssertionError(f"{phase} batch {i}: {k} has shape {tuple(v.shape)}")
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise AssertionError(f"{phase} batch {i}: {k} is not finite")
        if int(det["valid"].sum(dim=1).min()) == 0:
            raise AssertionError(f"{phase} batch {i}: an image has no detection")

    det_p = get_inference_fn(model, cfg, suppress=greedy_nms_plain, int8_plain=True)(images[0], intrinsics)
    torch.cuda.synchronize()
    for k in dets[0]:
        if not torch.equal(dets[0][k], det_p[k]):
            raise AssertionError(f"{phase}: {k} differs between the int8 kernel path and the int8 plain path")
    log(f"{phase} int8 kernel-path and plain-path detections identical ({int(det_p['valid'].sum())} kept)")

    det_b = get_inference_fn(model, bf16_cfg)(images[0], intrinsics)
    sa, sb = top_scores(det_b), top_scores(dets[0])
    drift = float((sa - sb).abs().mean())
    mass = abs(float(sa.sum()) - float(sb.sum())) / max(float(sa.sum()), 1e-6)
    log(f"{phase} int8 vs bf16, top-50 scores of batch 0: mean |diff| {drift:.4f} (limit 0.05), "
        f"relative score mass {mass:.4f} (limit 0.25)")
    if drift >= 0.05 or mass >= 0.25:
        raise AssertionError(f"{phase}: int8 detections drift too far from bf16")
    log(f"{phase} ok ({time.time() - t0:.2f} s)")
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


def device_rows(prof):
    """The profile's key_averages rows of device work: CUDA-typed rows, less
    the device-side copies of host annotations (the program's spans), which
    cover kernels already counted."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]


def device_ms_by_kernel(fn, reps, profiler):
    """{kernel name: device ms a call of `fn`}, from one profiler window over
    `reps` calls (after one call outside it). The profiler now and then
    records no device activity in a window: that window is taken again, and
    after a second empty one `fn` is timed with CUDA events as one entry."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profiler() as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel = {e.key: (getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)) / 1e3
                     / reps for e in device_rows(prof)}
        if sum(by_kernel.values()) > 0:
            return by_kernel
    log("  the profiler recorded no device time in two windows: CUDA events instead")
    return {"all kernels (CUDA events)": cuda_ms(fn, reps)}


def device_ms(fn, reps, profiler):
    """Device time of one call of `fn`, from one profiler window over `reps`
    calls: every kernel in the window is charged to `fn` (a wrapper's own
    copies too), and the host's launch overhead does not inflate it (at a
    small shape the wrapper's host time exceeds the kernel's, so CUDA events
    around a loop of calls would time the host)."""
    return sum(device_ms_by_kernel(fn, reps, profiler).values())


def int8_conv_sites_timing(cases, min_ch, phase="phase9"):
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
        log(f"{phase} int8 conv (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} x{count}/forward, device time: "
            f"kernel {k_ms:.4f} ms, cuDNN bf16 {c_ms:.4f} ms, bound {bnd:.5f} ms by {by} ({bnd / k_ms:.2f} of it)")
        for key in ("serving", "all") if c >= min_ch else ("all",):
            acc = sums[key]
            acc[0] += count * k_ms
            acc[1] += count * c_ms
            acc[2] += count * bnd
            acc[3] += count
    for key, (k_sum, c_sum, b_sum, n) in sums.items():
        log(f"{phase} int8 convs a forward, {key} ({n} convs), device time: kernel {k_sum:.3f} ms, cuDNN bf16 "
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


class no_fusion:
    """The unfused int8 path, for comparison: a stand-in for
    `TowerConv.link_amax` that finds no consumer's amax, so every tower link
    runs as before the s8 epilogue (int8 conv to bf16, ReLU, quantize). No
    config key selects it."""

    def __enter__(self):
        from dd3d_tpu_torch.models.layers import TowerConv

        self.real = TowerConv.__dict__["link_amax"]
        TowerConv.link_amax = lambda *args: None
        return self

    def __exit__(self, *exc):
        from dd3d_tpu_torch.models.layers import TowerConv

        TowerConv.link_amax = self.real


class counted_relu:
    """Count the calls of torch.nn.functional.relu (one kernel launch each
    on the card) while entered."""

    def __enter__(self):
        import torch.nn.functional as F

        self.real, self.calls = F.relu, 0

        def relu(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        F.relu = relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.relu = self.real


def fusion_ab(model, cfg8, images, intrinsics, phase, card):
    """The static-int8 path with the tower links fused (the s8 epilogue) and
    unfused (`no_fusion`), in turns (fused, unfused, unfused, fused): each
    turn serves the N_BATCHES batches counting the launches of the quantize,
    of the int8 conv by output kind and the ReLU calls, then takes the
    profiler's device time and launches a batch (serving_profile) and the
    median ms a batch over one timed pass (after a warm-up batch). Every
    batch's detections must be
    identical in both arms. Returns {arm: {"launches": per forward,
    "device_ms": [...], "ms": [...], "kernels": [...]}}."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.int8_conv import int8_conv
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    t0 = time.time()
    infer = get_inference_fn(model, cfg8)
    out, dets = {}, {}
    for arm in ("fused", "unfused", "unfused", "fused"):
        with (no_fusion() if arm == "unfused" else contextlib.nullcontext()):
            quantize_int8.launches = int8_conv.launches = 0
            int8_conv.launches_by_out.update(dict.fromkeys(int8_conv.launches_by_out, 0))
            with counted_relu() as relu:
                got = [infer(im, intrinsics) for im in images]
            torch.cuda.synchronize()
            counts = {"quantize_int8": quantize_int8.launches / N_BATCHES, "relu": relu.calls / N_BATCHES,
                      **{f"int8_conv_{k}": v / N_BATCHES for k, v in int8_conv.launches_by_out.items()}}
            dev_ms, n_kernels = serving_profile(infer, images, intrinsics)
            infer(images[0], intrinsics)
            times = []
            for im in images:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                infer(im, intrinsics)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            ms = float(np.median(times))
        entry = out.setdefault(arm, {"launches": counts, "device_ms": [], "ms": [], "kernels": []})
        if entry["launches"] != counts:
            raise AssertionError(f"{phase}: the {arm} arm's launches moved between turns: {entry['launches']}, "
                                 f"{counts}")
        entry["device_ms"].append(dev_ms)
        entry["ms"].append(ms)
        entry["kernels"].append(n_kernels)
        if arm in dets:
            continue
        dets[arm] = got
    for i, (a, b) in enumerate(zip(dets["fused"], dets["unfused"])):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"{phase}: batch {i}'s {k} differs between the fused and the unfused int8 path")
    f, u = out["fused"], out["unfused"]
    if f["launches"]["int8_conv_s8"] == 0 or u["launches"]["int8_conv_s8"] != 0:
        raise AssertionError(f"{phase}: s8 launches a forward, fused {f['launches']}, unfused {u['launches']}")
    for arm, e in out.items():
        e["images_per_s"] = BATCH / (np.mean(e["ms"]) / 1e3)
        log(f"{phase} int8 tower links {arm} on {card}: launches a forward {e['launches']}; device time a batch "
            f"(profiler) {e['device_ms'][0]:.3f} / {e['device_ms'][1]:.3f} ms, {e['kernels'][0]:.0f} kernels a "
            f"batch; median {e['ms'][0]:.3f} / {e['ms'][1]:.3f} ms a batch = {e['images_per_s']:.2f} images/s")
    log(f"{phase} fused against unfused: identical detections on {N_BATCHES} batches; quantize launches a forward "
        f"{u['launches']['quantize_int8']:.0f} -> {f['launches']['quantize_int8']:.0f}, ReLU "
        f"{u['launches']['relu']:.0f} -> {f['launches']['relu']:.0f}; device time "
        f"{np.mean(u['device_ms']):.3f} -> {np.mean(f['device_ms']):.3f} ms a batch ({time.time() - t0:.1f} s)")
    return out


def standalone_quantize_timing(model, cfg8, images, intrinsics, phase, card):
    """The quantize kernel at the shapes of every standalone launch of one
    static-int8 forward with the tower links fused
    (bench_quantize.quantize_shapes), each shape's device time (profiler) in
    turns with `x.to(torch.int8)` of the same tensor (kernel, cast, cast,
    kernel): the cast moves the same bytes (2 in, 1 out an element), so it
    is a yardstick of the bandwidth a streaming kernel reaches on this card
    now; it is not the same function. Summed as count x ms over the
    forward, beside the summed byte bound. Returns the totals."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.bench_quantize import quantize_shapes
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    shapes = quantize_shapes(get_inference_fn(model, cfg8), images[0], intrinsics)
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    gen = torch.Generator().manual_seed(SEED + 34)
    tot = {"kernel": 0.0, "cast": 0.0, "bound": 0.0, "n": 0}
    for (shape, dtype), count in sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][0])):
        x = (torch.randn(shape, generator=gen) * 3).to(images[0].device, dtype)
        xs = (x.float().abs().amax() / 127).reshape(1)
        fns = {"kernel": lambda: quantize_int8(x, xs), "cast": lambda: x.to(torch.int8)}
        t = {"kernel": [], "cast": []}
        for name in ("kernel", "cast", "cast", "kernel"):
            t[name].append(device_ms(fns[name], 10, prof))
        bnd = bound_ms(x.numel() * (x.element_size() + 1), 0, "f32")[0]
        k_ms, c_ms = float(np.mean(t["kernel"])), float(np.mean(t["cast"]))
        log(f"{phase} standalone quantize {shape} {str(dtype)[6:]} x{count}/forward: kernel "
            f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f} ms, cast {t['cast'][0]:.4f} / {t['cast'][1]:.4f} ms, "
            f"bound {bnd:.5f} ms by bytes ({bnd / k_ms:.2f} of the kernel, {bnd / c_ms:.2f} of the cast)")
        tot["kernel"] += count * k_ms
        tot["cast"] += count * c_ms
        tot["bound"] += count * bnd
        tot["n"] += count
    log(f"{phase} timing on {card}: the {tot['n']} standalone quantizes of a fused static-int8 forward, device time "
        f"summed: kernel {tot['kernel']:.4f} ms, the same-bytes cast {tot['cast']:.4f} ms, bound {tot['bound']:.4f} "
        f"ms ({tot['bound'] / tot['kernel']:.2f} of the kernel's time, {tot['bound'] / tot['cast']:.2f} of the "
        f"cast's)")
    return tot


# (B, H, W, CI, CO, k): the stem's base_layer and level0 convs of the train
# step, scripts/bench_pallas_dw.py's two shapes at batch 8, and a ragged one
DW_SHAPES = [(BATCH, HEIGHT, WIDTH, 3, 16, 7), (BATCH, HEIGHT, WIDTH, 16, 16, 3), (BATCH, 192, 640, 12, 64, 5),
             (BATCH, 192, 640, 64, 64, 3), (3, 37, 53, 5, 7, 9)]
# the stem convs at the CLI's smallest and largest resize bucket: KITTI's
# 375x1242 frames resized to a short side of 288 and 576, padded to 128
BUCKET_CANVASES = ((384, 1024), (640, 1920))
DW_SHAPES += [(BATCH, h, w, ci, 16, k) for h, w in BUCKET_CANVASES for ci, k in ((3, 7), (16, 3))]
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
    two stem convs at 384x1280 and at the two bucket canvases, for
    timing)."""
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
        if b == BATCH and (h, w) in ((HEIGHT, WIDTH), *BUCKET_CANVASES):
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
    kernels = device_rows(prof)
    device_us = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0), e.key)
                 for e in kernels]
    busy = sum(t for t, _ in device_us)
    launches = sum(e.count for e in kernels) / len(batches)
    log(f"phase13 profiled {len(batches)} steps: device time {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall = "
        f"busy share {busy / wall_us:.3f} (under the profiler); {launches:.0f} kernel launches a step, "
        f"{len(kernels)} kernel names")
    for t, name in sorted(device_us, reverse=True)[:15]:
        log(f"phase13   {t / 1e3 / len(batches):9.3f} ms/step  {name[:110]}")

    kernel_ms = {}  # (k, H, W) -> (kernel, plain, bound, bound_by, cuDNN)
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
        key = (k, *x.shape[2:])
        kernel_ms[key] = ((k_a + k_b) / 2, (p_a + p_b) / 2, bnd, by, (c_a + c_b) / 2)
        log(f"phase13 dW x {tuple(x.shape)} k={k} -> CO={co} ({flop / 1e9:.1f} GFLOP): kernel {k_a:.4f} / {k_b:.4f} "
            f"ms ({flop / 1e9 / kernel_ms[key][0]:.1f} TFLOP/s), plain {p_a:.4f} / {p_b:.4f} ms, cuDNN bf16 wgrad "
            f"{c_a:.4f} / {c_b:.4f} ms; bound {bnd:.4f} ms by {by}, {bnd / kernel_ms[key][0]:.2f} of the kernel's time")
    return ms, peak, kernel_ms


CLI_STEPS = 8
# The train loader on its thread path: for the training runs after phase
# 15, which times the process pool, so that none spawns a pool (~10 s each).
THREAD_LOADER = "DATALOADER.TRAIN.USE_PROCESS_POOL=False"
TIMING_STEPS = 8
CAR_AP3D = "kitti_3d/kitti_box3d_r40/Car_Moderate_0.5"
OVERFIT_ITERS = 400  # the overfit run's steps of batch 4 (phase 17; ~120 s on the card)
EVAL_IMAGES = 80  # frames of phase 18's test set (20 batches of 4; 120 until PR 15, 200 until PR 13)
TIMING_BUCKET = 384  # KITTI frames at short side 384: a 384x1280 canvas, phase 13's shape


def cli_overrides(root, out_root, max_iter, *extra):
    """The CLI's arguments: dd3d_kitti_dla34_overfit at full width from the
    fixture, the stem dW on the kernel, checkpoints every 4 steps, no
    periodic test, the final test without test-time augmentation (phase
    20 runs it) and no dataloader drawing (phase 19 draws)."""
    return ["+experiments=dd3d_kitti_dla34_overfit", f"DATASET_ROOT={root}", f"OUTPUT_ROOT={out_root}",
            "TPU.PALLAS_STEM_DW=True", f"SOLVER.MAX_ITER={max_iter}", "SOLVER.CHECKPOINT_PERIOD=4",
            "TEST.EVAL_PERIOD=0", "TEST.AUG.ENABLED=False", "VIS.DATALOADER_ENABLED=False", *extra]


def recording_train_steps(steps):
    """Stand a wrapper in for the train loop's make_train_step that appends,
    for each step, (the host clock at its call, its image shape, its total
    loss). Reading the loss waits for the step, so the clock's differences
    are whole steps, the wait for the batch included."""
    import dd3d_tpu_torch.training.train_loop as train_loop

    real = train_loop.make_train_step

    def make(cfg, model, optimizer):
        step = real(cfg, model, optimizer)

        def recorded(batch):
            t = time.perf_counter()
            metrics = step(batch)
            steps.append((t, list(batch["image"].shape), float(metrics["total_loss"])))
            return metrics
        return recorded

    train_loop.make_train_step = make


def step_ms(steps):
    """ms of each recorded step but the last, from the clock's differences."""
    return [(b[0] - a[0]) * 1e3 for a, b in zip(steps, steps[1:])]


def cli_rank(argv):
    """Phase 14 inside torch.distributed.run: the CLI's main with the dW
    kernel's launch count and SyncBN's all-reduce count set to 0 just before
    and read just after, printed as one CLI_RESULT JSON line."""
    from dd3d_tpu_torch.models.layers import sync_batch_moments
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.train import main as train_main

    steps = []
    recording_train_steps(steps)
    if f"+experiments={V99}" in argv:
        build_damped_models()
    conv_dw.conv_dw_s1_same.launches = 0
    sync_batch_moments.calls = 0
    out_dir = train_main(argv)
    torch.cuda.synchronize()
    print("CLI_RESULT " + json.dumps({"output_dir": out_dir, "dw_launches": conv_dw.conv_dw_s1_same.launches,
                                      "syncbn_forward_allreduces": sync_batch_moments.calls,
                                      "shapes": [s[1] for s in steps], "losses": [s[2] for s in steps],
                                      "step_ms": step_ms(steps),
                                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}), flush=True)


def cli_timing(argv):
    """Phase 15 inside torch.distributed.run, in one process group (NCCL,
    DDP): `train()` on synthetic batches of the bucket's shape, then the
    CLI's main at that one resize bucket (main leaves the group at its
    end); each step's time includes the wait for its batch."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.augmentations import resize_shortest_edge_dims
    from dd3d_tpu_torch.data.mapper import pad_to_divisibility
    from dd3d_tpu_torch.train import main as train_main
    from dd3d_tpu_torch.training.train_loop import train
    from dd3d_tpu_torch.utils import comm

    cfg = get_experiment_cfg("dd3d_kitti_dla34_overfit")
    cfg.TPU.PALLAS_STEM_DW = True
    device = comm.resolve_device()
    comm.init_distributed(device)
    h, w = pad_to_divisibility(*resize_shortest_edge_dims(375, 1242, TIMING_BUCKET, 10000), 128)
    batches = train_batches(cfg, 4, BATCH, h, w, SEED + 10)
    steps = []
    recording_train_steps(steps)
    train(cfg, [batches[i % 4] for i in range(TIMING_STEPS)], model=build_train_model(cfg, "cpu"),
          device=device, max_iter=TIMING_STEPS)
    synthetic = steps[:]
    train_main(argv)
    loader = steps[len(synthetic):]
    print("CLI_RESULT " + json.dumps({"loader_ms": step_ms(loader), "synthetic_ms": step_ms(synthetic),
                                      "shapes": [s[1] for s in loader], "synthetic_shape": [h, w]}), flush=True)


def run_child(cmd, timeout_s=300):
    """`python cmd...` from the repo's root: (its CompletedProcess, seconds)."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, *cmd], capture_output=True, text=True, timeout=timeout_s,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.time() - t0


def cli_child(mode, args, timeout_s=600):
    """`chip_smoke.py <mode> args` under torch.distributed.run on one card:
    (its CompletedProcess, seconds); cli_result reads it."""
    return run_child(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                      os.path.abspath(__file__), mode, *args], timeout_s)


def cli_output(child):
    """The parsed CLI_RESULT line of a cli_child, or None."""
    result = [line for line in child[0].stdout.splitlines() if line.startswith("CLI_RESULT ")]
    return json.loads(result[0][len("CLI_RESULT "):]) if child[0].returncode == 0 and len(result) == 1 else None


def cli_result(mode, child):
    """A cli_child's parsed CLI_RESULT line, with the child's whole output
    under "log" and its seconds under "seconds". The child's log tail is
    printed."""
    proc, seconds = child
    for line in (proc.stdout + proc.stderr).splitlines()[-12:]:
        log(f"  | {line[:220]}")
    if proc.returncode != 0:
        raise AssertionError(f"{mode}: the CLI exited {proc.returncode}")
    out = cli_output(child)
    if out is None:
        raise AssertionError(f"{mode}: no CLI_RESULT line")
    out["seconds"] = seconds
    out["log"] = proc.stdout + proc.stderr
    return out


def run_cli(mode, args, timeout_s=600):
    """cli_result of a cli_child run now."""
    return cli_result(mode, cli_child(mode, args, timeout_s))


def experiment_cfg(name, **overrides):
    """The experiment's config with {dotted key: value} overrides."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg(name)
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for part in parents:
            node = node[part]
        node[leaf] = value
    return cfg


def loader_cfg(root, **overrides):
    return experiment_cfg("dd3d_kitti_dla34_overfit", DATASET_ROOT=root, **overrides)


def kitti_cli_children(tmp, root):
    """Phase 14's child, the training CLI from the port's fixture, then
    phase 16's, EVAL_ONLY from its checkpoint."""
    out = {"train": cli_child("--cli-rank", cli_overrides(root, os.path.join(tmp, "out"), CLI_STEPS))}
    trained = cli_output(out["train"])
    if trained is not None:
        out["eval"] = cli_child("--eval-only", [
            "+experiments=dd3d_kitti_dla34_overfit", "EVAL_ONLY=True",
            f"MODEL.CKPT={os.path.join(trained['output_dir'], 'ckpt')}", "TEST.AUG.ENABLED=False",
            "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0", f"DATASET_ROOT={root}",
            f"OUTPUT_ROOT={os.path.join(tmp, 'out_eval')}"])
    return out


def phase14_cli(root, child):
    """The training CLI from the port's fixture (kitti_cli_children); checks
    in the docstring of this file. Returns (the dW kernel's launches,
    SyncBN's all-reduces a step, the run's directory)."""
    from dd3d_tpu_torch.data.build import TrainDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.training.checkpoint import CheckpointManager
    from dd3d_tpu_torch.training.train_loop import close_iterator, train

    res = cli_result("--cli-rank", child)
    run_dir = res["output_dir"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        all_rows = [json.loads(line) for line in f]
    rows = [r for r in all_rows if "total_loss" in r]  # the last step's (the loop logs every 20 and at the end)
    tests = [r for r in all_rows if "total_loss" not in r]  # the final test's results
    buckets = sorted({tuple(s[1:3]) for s in res["shapes"]})
    steps = CheckpointManager(os.path.join(run_dir, "ckpt")).steps()
    log(f"phase14 CLI: {len(res['shapes'])} steps of batch {BATCH} in {res['seconds']:.1f} s (process start, "
        f"fixture loader and model included; beside the other children); canvases {buckets}; dW kernel launches "
        f"{res['dw_launches']}; SyncBN all-reduces {res['syncbn_forward_allreduces']} in forward passes "
        f"({res['syncbn_forward_allreduces'] // max(len(res['shapes']), 1)} a step, as many in backward); "
        f"checkpoints {steps}")
    log("phase14 total loss by step: " + ", ".join(f"{v:.3f}" for v in res["losses"]) + "; ms a step (the wait "
        "for the batch included, the first with set-up): " + ", ".join(f"{v:.1f}" for v in res["step_ms"]))
    log(f"phase14 metrics.jsonl: {rows}")
    if len(res["losses"]) != CLI_STEPS or not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"phase14: {len(res['losses'])} steps of {CLI_STEPS}, or a loss not finite")
    if [r["step"] for r in rows] != [CLI_STEPS] or not all(np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"phase14: metrics.jsonl holds {rows}")
    if [r["step"] for r in tests] != [CLI_STEPS] or not np.isfinite(tests[0].get(CAR_AP3D, np.nan)):
        raise AssertionError(f"phase14: no final test results at step {CLI_STEPS} in metrics.jsonl")
    log(f"phase14 final test at step {CLI_STEPS}: {CAR_AP3D} = {tests[0][CAR_AP3D]:.4f}")
    if len(buckets) < 2:
        raise AssertionError(f"phase14: one resize bucket in {CLI_STEPS} steps: {buckets}")
    if res["dw_launches"] != 2 * CLI_STEPS:
        raise AssertionError(f"phase14: {res['dw_launches']} dW kernel launches, not {2 * CLI_STEPS}")
    if not {4, 8} <= set(steps):
        raise AssertionError(f"phase14: checkpoints {steps}, not 4 and 8")

    cfg = loader_cfg(root, **{"TPU.PALLAS_STEM_DW": True, "VIS.DATALOADER_ENABLED": False,
                              "DATALOADER.TRAIN.USE_PROCESS_POOL": False})
    register_datasets(cfg)
    it = iter(TrainDataLoader(cfg))
    try:
        state = train(cfg, (batch for batch, _meta in it), model=build_train_model(cfg, "cpu"),
                      max_iter=CLI_STEPS + 2, output_dir=run_dir, log_period=1)
    finally:
        close_iterator(it)
    log(f"phase14 resume: train() from {run_dir} ran to step {state.step}, optimizer count "
        f"{state.optimizer.count}; checkpoints {CheckpointManager(os.path.join(run_dir, 'ckpt')).steps()}")
    if state.step != CLI_STEPS + 2 or state.optimizer.count != CLI_STEPS + 2:
        raise AssertionError("phase14: train() did not resume at step 8 and take 2 more steps")
    log("phase14 ok")
    return res["dw_launches"], res["syncbn_forward_allreduces"] // CLI_STEPS, run_dir


def loader_images_per_s(root, use_processes, batches=6):
    """Images/s of the train loader alone from the fixture, after 2 warm-up
    batches (the pool's start)."""
    from dd3d_tpu_torch.data.build import TrainDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.training.train_loop import close_iterator

    cfg = loader_cfg(root, **{"DATALOADER.TRAIN.USE_PROCESS_POOL": use_processes})
    register_datasets(cfg)
    loader = TrainDataLoader(cfg)
    it = iter(loader)
    try:
        for _ in range(2):
            next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        return batches * loader.batch_size / (time.perf_counter() - t0), loader.num_workers
    finally:
        close_iterator(it)


def phase15_cli_timing(tmp, root, card):
    """The loader alone (thread path, process pool), then the CLI's median
    step time with the loader against synthetic batches of the same shape."""
    ips = {}
    for use_processes in (False, True):
        ips[use_processes], workers = loader_images_per_s(root, use_processes)
        log(f"phase15 loader alone on {card}: {'process pool' if use_processes else 'thread path'} "
            f"({workers} workers, {os.cpu_count()} host cores): {ips[use_processes]:.1f} images/s at batch {BATCH}")
    res = run_cli("--cli-timing", cli_overrides(root, os.path.join(tmp, "out_timing"), TIMING_STEPS,
                                                f"INPUT.RESIZE.MIN_SIZE_TRAIN=[{TIMING_BUCKET}]"))
    loader_med, synth_med = float(np.median(res["loader_ms"][2:])), float(np.median(res["synthetic_ms"][2:]))
    log(f"phase15 ms a step with the loader: {[round(v, 1) for v in res['loader_ms']]}; on synthetic batches: "
        f"{[round(v, 1) for v in res['synthetic_ms']]}")
    if {tuple(s[1:3]) for s in res["shapes"]} != {tuple(res["synthetic_shape"])}:
        raise AssertionError(f"phase15: the loader's canvases {res['shapes'][:3]} are not {res['synthetic_shape']}")
    log(f"phase15 CLI step on {card}, bucket {TIMING_BUCKET} (canvas {res['shapes'][0][1:3]}), batch {BATCH}, "
        f"medians of steps 3-{TIMING_STEPS - 1}: {loader_med:.2f} ms with the loader, {synth_med:.2f} ms on synthetic "
        f"batches ({res['seconds']:.1f} s for both runs)")
    if not (np.isfinite(loader_med) and np.isfinite(synth_med)):
        raise AssertionError("phase15: a step time is not finite")
    return ips, loader_med, synth_med


def eval_only(argv):
    """Phase 16's CLI inside torch.distributed.run: the CLI's main with
    EVAL_ONLY, the NMS kernel's launch count set to 0 just before and read
    just after, printed as one CLI_RESULT line."""
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms
    from dd3d_tpu_torch.train import main as train_main

    greedy_nms.launches = 0
    out_dir = train_main(argv)
    torch.cuda.synchronize()
    print("CLI_RESULT " + json.dumps({"output_dir": out_dir, "nms_launches": greedy_nms.launches}), flush=True)


def same_results(a, b) -> bool:
    """Results dicts equal key for key and value for value, NaN equal to NaN
    (a COCO area range without ground truth reads NaN)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b) and all(
            same_results(a[k], b[k]) for k in a)
    return a == b or (isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b))


def same_detections(a, b) -> bool:
    """Per-image detection dicts equal: the same images in the same order,
    each field exactly."""
    return len(a) == len(b) and all(p.keys() == q.keys() and all(
        np.array_equal(np.asarray(p[k]), np.asarray(q[k])) for k in p) for p, q in zip(a, b))


class Recorder:
    """An evaluator that keeps the per-image detections it is given."""

    def reset(self):
        self.dets = []

    def process(self, per_image):
        self.dets += per_image

    def evaluate(self):
        return {}


class TimedEvaluator:
    """An evaluator's host seconds in `process` and in `evaluate`."""

    def __init__(self, evaluator):
        self.evaluator, self.process_s, self.evaluate_s = evaluator, 0.0, 0.0

    def reset(self):
        self.evaluator.reset()

    def process(self, per_image):
        t0 = time.perf_counter()
        self.evaluator.process(per_image)
        self.process_s += time.perf_counter() - t0

    def evaluate(self):
        t0 = time.perf_counter()
        out = self.evaluator.evaluate()
        self.evaluate_s += time.perf_counter() - t0
        return out


def kernel_and_plain(model, cfg, loader, phase):
    """inference_on_dataset over `loader`, through the NMS kernel (its count
    set to 0 just before, read just after) and then with the plain
    suppression, each with a Recorder beside the dataset's evaluators. The
    per-image detections must be equal exactly and the results dicts key for
    key; the plain turn must launch no NMS kernel. Returns, per turn,
    (results, seconds, NMS launches, detections, {evaluator: (process s,
    evaluate s)}, the R40 engine's seconds)."""
    from dd3d_tpu_torch.evaluators import get_evaluator
    from dd3d_tpu_torch.evaluators.kitti_3d import KITTIEvaluationEngine
    from dd3d_tpu_torch.models.postprocess import inference_on_dataset
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    engine_s = []
    engine_evaluate = KITTIEvaluationEngine.evaluate

    def timed_engine(self, *args):
        t0 = time.perf_counter()
        out = engine_evaluate(self, *args)
        engine_s.append(time.perf_counter() - t0)
        return out

    turns = {}
    KITTIEvaluationEngine.evaluate = timed_engine
    try:
        for turn, suppress in (("kernel", None), ("plain", greedy_nms_plain)):
            evaluators = [TimedEvaluator(ev) for ev in get_evaluator(cfg, cfg.DATASETS.TEST.NAME)]
            recorder = Recorder()
            greedy_nms.launches = 0
            t0 = time.perf_counter()
            results = inference_on_dataset(model, cfg, loader, evaluators + [recorder], suppress=suppress)
            seconds = time.perf_counter() - t0
            parts = {type(ev.evaluator).__name__: (ev.process_s, ev.evaluate_s) for ev in evaluators}
            turns[turn] = (results, seconds, greedy_nms.launches, recorder.dets, parts, engine_s[-1])
    finally:
        KITTIEvaluationEngine.evaluate = engine_evaluate
    (res_k, _, launches, dets_k, _, _), (res_p, _, plain_launches, dets_p, _, _) = turns["kernel"], turns["plain"]
    kept = sum(len(d["scores"]) for d in dets_k)
    log(f"{phase} inference_on_dataset, NMS kernel and plain suppression: {len(dets_k)} images, {kept} detections "
        f"kept, NMS kernel launches {launches} / {plain_launches} for {len(loader)} batches; detections identical: "
        f"{same_detections(dets_k, dets_p)}, results identical: {same_results(res_k, res_p)}")
    if len(dets_k) != len(loader.sampler) or kept == 0:
        raise AssertionError(f"{phase}: {len(dets_k)} images of {len(loader.sampler)}, {kept} detections")
    if not same_detections(dets_k, dets_p):
        raise AssertionError(f"{phase}: detections through the NMS kernel and with the plain suppression differ")
    if not same_results(res_k, res_p):
        raise AssertionError(f"{phase}: results through the NMS kernel and with the plain suppression differ")
    if launches < len(loader) or plain_launches != 0:
        raise AssertionError(f"{phase}: NMS kernel launches {launches} / {plain_launches} for {len(loader)} batches")
    if not np.isfinite(res_k["kitti_3d"]["kitti_box3d_r40/Car_Moderate_0.5"]):
        raise AssertionError(f"{phase}: the Car AP is not finite")
    return turns


def start_cli_children(tmp, root):
    """Start the children of phases 14, 16, 17, 19, 24, 28, 31 and 32 at
    once, each chain on a thread of this process. They read nothing of this
    process but the built kernels and its fixture, and their kernels launch
    in their own processes, so this process's launch counts are untouched;
    meanwhile this process runs only phases that time nothing. Their checks
    run later, in phase order. Returns what wait_cli_children takes."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(8)
    overfit = pool.submit(overfit_child, tmp, root)
    jobs = {14: pool.submit(kitti_cli_children, tmp, root),
            17: overfit,
            19: pool.submit(vis_children, tmp, root, overfit),
            24: pool.submit(v99_children, tmp),
            28: pool.submit(nusc_children, tmp),
            31: pool.submit(regnety_predict_children, tmp),
            32: pool.submit(regnety_train_children, tmp)}
    return pool, jobs, time.time()


def wait_cli_children(started):
    """{phase: its children} once every chain of start_cli_children is done."""
    pool, jobs, t0 = started
    out = {phase: job.result() for phase, job in jobs.items()}
    pool.shutdown()
    log(f"the CLI children of phases {', '.join(map(str, out))} ran at once in {time.time() - t0:.1f} s (phases "
        "1-4, 6-8 and 10-12 beside them)")
    return out


def phase16_eval(root, run_dir, device, child):
    """EVAL_ONLY through the CLI (under torch.distributed.run) from phase
    14's checkpoint (kitti_cli_children), then inference_on_dataset in this process on the same
    loader's batches through the NMS kernel and with the plain suppression:
    identical detections and results, at least one kernel launch a batch."""
    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.train import flatten_results
    from dd3d_tpu_torch.training.checkpoint import load_weights

    ckpt = os.path.join(run_dir, "ckpt")
    # 10 steps from He-initialized weights score every box below the 0.05
    # pre-NMS threshold: at 0 the NMS kernel and the evaluators get real work
    cfg = loader_cfg(root, **{"TEST.AUG.ENABLED": False, "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH": 0.0})
    register_datasets(cfg)
    loader = build_test_dataloader(cfg, dataset_name=cfg.DATASETS.TEST.NAME)
    n_images, n_batches = len(loader.sampler), len(loader)

    res = cli_result("--eval-only", child)
    out_dir = res["output_dir"]
    with open(os.path.join(out_dir, "kitti_predictions.json")) as f:
        n_predictions = len(json.load(f))
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        cli_rows = [json.loads(line) for line in f]
    logged = [k for k in (CAR_AP3D, "bbox/AP") if f"{k} = " in res["log"]]
    log(f"phase16 EVAL_ONLY CLI from {ckpt} ({res['seconds']:.1f} s, process start and model included): "
        f"{n_predictions} predictions in kitti_predictions.json, NMS kernel launches {res['nms_launches']} for "
        f"{n_batches} batch(es) of {n_images} images; logged {logged}; {CAR_AP3D} = "
        f"{cli_rows[-1].get(CAR_AP3D, float('nan')):.4f}")
    if n_predictions == 0 or len(logged) != 2 or len(cli_rows) != 1 or "bbox/AP" not in cli_rows[0]:
        raise AssertionError("phase16: the EVAL_ONLY CLI did not write and log its results")
    if res["nms_launches"] < n_batches:
        raise AssertionError(f"phase16: {res['nms_launches']} NMS kernel launches for {n_batches} batches")

    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    step = load_weights(model, ckpt)
    turns = kernel_and_plain(model.to(device), cfg, loader, "phase16")
    res_k = turns["kernel"][0]
    cli = {k: v for k, v in cli_rows[0].items() if k not in ("step", "ts")}
    log(f"phase16 ok: checkpoint step {step}; kernel and plain identical ({len(flatten_results(res_k))} metrics); "
        f"in-process results equal the CLI's: {same_results(flatten_results(res_k), cli)}")
    return turns["kernel"][2]


def phase18_eval_scale(tmp, overfit_dir, device, card):
    """Evaluation at the size of a test set: the overfit run's trained
    checkpoint over EVAL_IMAGES frames of the fixture (the first 8 are the
    frames it trained on), batch 4 at 384x1280, bf16. The loader alone, then
    inference_on_dataset through the NMS kernel and with the plain
    suppression (kernel_and_plain's checks): images/s, each evaluator's
    seconds and the R40 engine's."""
    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_plain
    from dd3d_tpu_torch.overfit_smoke import make_fixture, overfit_cfg
    from dd3d_tpu_torch.training.checkpoint import load_weights

    t0 = time.time()
    root = make_fixture(os.path.join(tmp, "fixture_eval"), n_images=EVAL_IMAGES)
    write_s = time.time() - t0
    cfg = overfit_cfg(root, OVERFIT_ITERS)
    register_datasets(cfg)
    loader = build_test_dataloader(cfg, dataset_name=cfg.DATASETS.TEST.NAME)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    step = load_weights(model, os.path.join(overfit_dir, "ckpt"))
    model = model.to(device)

    t0 = time.perf_counter()
    batches = [batch for batch, _meta in loader]
    loader_s = time.perf_counter() - t0
    for suppress in (None, greedy_nms_plain):  # warm-up at the batch's shape: cuDNN, the kernels
        get_inference_fn(model, cfg, suppress=suppress)(batches[0]["image"], batches[0]["intrinsics"])
    del batches
    torch.cuda.synchronize()

    turns = kernel_and_plain(model, cfg, loader, "phase18")
    res, sec, launches, dets, parts, r40_s = turns["kernel"]
    n = len(dets)
    ips = {turn: n / t[1] for turn, t in turns.items()}
    kitti = res["kitti_3d"]
    log(f"phase18 on {card}: the overfit checkpoint (step {step}) over {n} frames (written in {write_s:.1f} s), "
        f"{len(loader)} batches of {cfg.TEST.IMS_PER_BATCH} at short side {cfg.INPUT.RESIZE.MIN_SIZE_TEST}, "
        f"{cfg.TPU.COMPUTE_DTYPE}: "
        f"{ips['kernel']:.2f} images/s with the NMS kernel ({sec:.3f} s: loader, forward, decode, evaluators), "
        f"{ips['plain']:.2f} with the plain suppression; the loader alone {n / loader_s:.2f} images/s "
        f"({loader_s:.3f} s); {sum(len(d['scores']) for d in dets)} detections kept; NMS kernel launches {launches}")
    log(f"phase18 host seconds of the kernel turn by evaluator (process, evaluate): "
        + ", ".join(f"{k} {p:.4f} / {e:.4f}" for k, (p, e) in parts.items())
        + f"; the R40 engine {r40_s:.4f} s of KITTI3DEvaluator.evaluate")
    log(f"phase18 AP over {n} frames: {CAR_AP3D} {kitti['kitti_box3d_r40/Car_Moderate_0.5']:.2f}, "
        f"BEV {kitti['kitti_bev_r40/Car_Moderate_0.5']:.2f}, COCO bbox/AP {res['bbox']['AP']:.2f}")
    log("phase18 ok")
    return {"images_per_s": ips["kernel"], "plain_images_per_s": ips["plain"], "loader_images_per_s": n / loader_s,
            "r40_s": r40_s, "parts": parts, "nms_launches": launches, "n_images": n}


def overfit_child(tmp, root):
    """Phase 17's child: `python -m dd3d_tpu_torch.overfit_smoke --iters
    OVERFIT_ITERS --n-images 8 --int8-ab` on the fixture with the stem dW on
    its kernel. Returns (its CompletedProcess, seconds, its output dir)."""
    out_dir = os.path.join(tmp, "out_overfit")
    return (*run_child(["-m", "dd3d_tpu_torch.overfit_smoke", "--iters", str(OVERFIT_ITERS), "--n-images", "8",
                        "--int8-ab", "--root", root, "--output-dir", out_dir, "TPU.PALLAS_STEM_DW=True",
                        THREAD_LOADER], 600), out_dir)


def phase17_overfit(child, card):
    """The overfit run (overfit_child): its AP, ms a step (beside the other
    children of cli_children), the int8 arm's worst |dAP| and each arm's
    kernel launches."""
    proc, seconds, out_dir = child
    lines = proc.stdout.splitlines()
    for line in [ln for ln in lines if not ln.startswith("INT8 AB: kitti")] + proc.stderr.splitlines()[-6:]:
        log(f"  | {line[:220]}")
    if proc.returncode != 0:
        raise AssertionError(f"phase17: the overfit run exited {proc.returncode}")

    def value(prefix):
        found = [ln for ln in lines if ln.startswith(prefix)]
        return float(found[-1].rsplit("=", 1)[1]) if found else float("nan")

    launches = {}
    for ln in lines:
        if ln.startswith("KERNEL LAUNCHES "):
            arm, counts = ln[len("KERNEL LAUNCHES "):].split(": ")
            launches[arm] = {k: int(v) for k, v in (c.split("=") for c in counts.split())}
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    windows = [r for r in rows if "imgs_per_sec" in r]
    ms_step = 4 / windows[-1]["imgs_per_sec"] * 1e3 if windows else float("nan")  # batch 4
    ap3d, bev, dap = (value("OVERFIT RESULT: Car Moderate AP3D@0.5"), value("OVERFIT RESULT: Car Moderate BEV@0.5"),
                      value("INT8 AB RESULT: worst |dAP|"))
    log(f"phase17 overfit run on {card}: {OVERFIT_ITERS} steps of batch 4 at 384x1280 in {seconds:.1f} s "
        f"(process start, loader, evaluations included; beside the other CLI children of phases 16-32); "
        f"{ms_step:.2f} ms a step over the last window of 20 "
        f"(steps {windows[-1]['step'] if windows else '-'}); Car Moderate AP3D@0.5 {ap3d:.2f}, BEV@0.5 {bev:.2f}; "
        f"int8 worst |dAP| {dap:.2f}; kernel launches {launches}")
    if not (np.isfinite(ap3d) and np.isfinite(bev) and np.isfinite(dap)):
        raise AssertionError("phase17: an AP is not finite")
    int8 = launches.get("int8", {})
    if int8.get("quantize_int8", 0) == 0 or int8.get("int8_conv", 0) == 0 or int8.get("greedy_nms", 0) < 2:
        raise AssertionError(f"phase17: the int8 arm did not launch the int8 kernels and NMS: {int8}")
    if launches.get("bf16", {}).get("greedy_nms", 0) < 2:
        raise AssertionError(f"phase17: the bf16 evaluation launched NMS {launches.get('bf16')} times for 2 batches")
    if launches.get("train", {}).get("conv_dw_s1_same") != 2 * OVERFIT_ITERS:
        raise AssertionError(f"phase17: training launched the dW kernel {launches.get('train')} times")
    log("phase17 ok")
    return {"ap3d": ap3d, "bev": bev, "dap": dap, "ms_step": ms_step, "seconds": seconds, "launches": launches,
            "output_dir": out_dir}


VIS_STEPS = 4  # phase 19's CLI run: steps of batch 8, the dataloader drawn at steps 2 and 4
VIS_LOADER_IMAGES = 4  # phase 19's visualize_dataloader samples
TTA_IMAGES = 16  # phase 20's frames (48 until PR 15, 32 until PR 16): one chunk at TEST.IMS_PER_BATCH = 80
LARGEST_BUCKET = 160  # instances of the largest TTA bucket at that chunk of 80 frames, with flip
TTA_CHECK_IMAGES = 8  # phase 20(c): int8 TTA through the kernels and through their plain versions
KITTI_INTRINSICS = "721.5377,721.5377,609.5593,172.854"
# the canvas buckets of a 375x1242 frame at TEST.AUG.MIN_SIZES [320, 384, 448, 512, 576], one scale and its flip each
TTA_BUCKETS = ("384x1152", "384x1280", "512x1536", "512x1792", "640x1920")


def vis_rank(argv):
    """Phase 19's CLI inside torch.distributed.run: the CLI's main, with each
    dataloader drawing's undrawn batch image and valid ground-truth boxes
    saved under `<output_dir>/undrawn/` (the drawing itself is the loop's);
    the output directory, each step's loss and the counts of dW kernel
    launches and SyncBN all-reduces (set to 0 just before) printed as one
    CLI_RESULT line."""
    import dd3d_tpu_torch.training.train_loop as train_loop
    from dd3d_tpu_torch.models.layers import sync_batch_moments
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.train import main as train_main

    real = train_loop._visualize_train_batch

    def record(batch, output_dir, storage, max_n, step):
        real(batch, output_dir, storage, max_n, step)
        raw = os.path.join(output_dir, "undrawn")
        os.makedirs(raw, exist_ok=True)
        imgs, boxes, valid = (batch[k].cpu().numpy() for k in ("image", "gt_boxes2d", "gt_valid"))
        for i in range(min(max_n, len(imgs))):
            np.savez(os.path.join(raw, f"dataloader_step{step:06d}_{i}.npz"), image=imgs[i],
                     boxes=boxes[i][valid[i].astype(bool)])

    train_loop._visualize_train_batch = record
    steps = []
    recording_train_steps(steps)
    conv_dw.conv_dw_s1_same.launches = 0
    sync_batch_moments.calls = 0
    out_dir = train_main(argv)
    torch.cuda.synchronize()
    print("CLI_RESULT " + json.dumps({"output_dir": out_dir, "dw_launches": conv_dw.conv_dw_s1_same.launches,
                                      "syncbn_forward_allreduces": sync_batch_moments.calls,
                                      "losses": [s[2] for s in steps]}), flush=True)


def drawn_inside(drawn, undrawn, box, margin=3) -> bool:
    """Whether `drawn` differs from `undrawn` within `margin` px of `box`."""
    h, w = drawn.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in box)
    r0, r1 = max(min(y1, y2) - margin, 0), min(max(y1, y2) + margin + 1, h)
    c0, c1 = max(min(x1, x2) - margin, 0), min(max(x1, x2) + margin + 1, w)
    return r0 < r1 and c0 < c1 and bool((drawn[r0:r1, c0:c1] != undrawn[r0:r1, c0:c1]).any())


def vis_children(tmp, root, overfit):
    """Phase 19's children: the training CLI under TPU.REMAT=full with the
    drawings on, `visualize_dataloader`, and `predict --vis` from the overfit
    run's checkpoint once `overfit` (overfit_child's future) is done."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        vis = pool.submit(cli_child, "--vis-rank", [
            "+experiments=dd3d_kitti_dla34_overfit", f"DATASET_ROOT={root}",
            f"OUTPUT_ROOT={os.path.join(tmp, 'out_vis')}", "TPU.PALLAS_STEM_DW=True", f"SOLVER.MAX_ITER={VIS_STEPS}",
            f"SOLVER.CHECKPOINT_PERIOD={VIS_STEPS}", "TEST.EVAL_PERIOD=0", f"VIS.DATALOADER_PERIOD={VIS_STEPS // 2}",
            THREAD_LOADER, "TPU.REMAT=full"])
        loader = pool.submit(run_child, [
            "-m", "dd3d_tpu_torch.visualize_dataloader", "--experiment", "dd3d_kitti_dla34_overfit", "--num-images",
            str(VIS_LOADER_IMAGES), "--output-dir", os.path.join(tmp, "loader_vis"), f"DATASET_ROOT={root}"])
        overfit_dir = overfit.result()[2]
        predict = run_child([
            "-m", "dd3d_tpu_torch.predict", "--experiment", "dd3d_kitti_dla34", "--images",
            os.path.join(root, "KITTI3D", "training", "image_2"), "--intrinsics", KITTI_INTRINSICS, "--ckpt",
            os.path.join(overfit_dir, "ckpt"), "--out", os.path.join(tmp, "predict_vis.json"), "--vis",
            os.path.join(tmp, "predict_vis"), "--score-thresh", "0.3"])
        return {"vis": vis.result(), "loader": loader.result(), "predict": predict}


def phase19_visualizers(tmp, root, card, children):
    """The visualizers on a machine without cv2: the training CLI with the
    experiment's own TEST.AUG and VIS (the dataloader period brought inside
    VIS_STEPS) draws the dataloader and, in its final test, the predictions;
    `predict --vis` and `python -m dd3d_tpu_torch.visualize_dataloader` write
    theirs. Each file is read back with the port's PNG reader: its shape, and
    that it differs from the undrawn frame where boxes are. (Phase 20's
    EVAL_ONLY checks its prediction drawings the same way.) The CLI trains
    under TPU.REMAT=full: phase 43 reads its steps. Returns its CLI_RESULT."""
    from dd3d_tpu_torch.data.augmentations import resize_shortest_edge_dims
    from dd3d_tpu_torch.data.build import build_train_dataloader
    from dd3d_tpu_torch.data.catalog import DatasetCatalog, register_datasets
    from dd3d_tpu_torch.data.imageio import read_image_bgr
    from dd3d_tpu_torch.visualizers.draw import BEVImage

    res = cli_result("--vis-rank", children["vis"])
    run_dir = res["output_dir"]
    vis = os.path.join(run_dir, "visualization")
    files = sorted(os.listdir(vis))
    loader_pngs = [f for f in files if f.startswith("dataloader_step")]
    pred_pngs = [f for f in files if f.startswith("pred_")]
    want = sorted(f"dataloader_step{s:06d}_{i}.png" for s in range(VIS_STEPS // 2, VIS_STEPS + 1, VIS_STEPS // 2)
                  for i in range(BATCH))
    cfg = loader_cfg(root)
    register_datasets(cfg)
    n_test = min(8, len(DatasetCatalog.get(cfg.DATASETS.TEST.NAME)))  # prediction drawings: 8 at most
    if loader_pngs != want or len(pred_pngs) != n_test:
        raise AssertionError(f"phase19: the CLI wrote {loader_pngs} and {pred_pngs}")
    n_boxes = 0
    for name in loader_pngs:
        drawn = read_image_bgr(os.path.join(vis, name))
        raw = np.load(os.path.join(run_dir, "undrawn", name[:-4] + ".npz"))
        if drawn.shape != raw["image"].shape or drawn.shape[1] % 128:
            raise AssertionError(f"phase19: {name} is {drawn.shape}, its batch image {raw['image'].shape}")
        for box in raw["boxes"]:
            n_boxes += 1
            if not drawn_inside(drawn, raw["image"], box):
                raise AssertionError(f"phase19: {name} is not drawn at its box {box}")
    test_hw = resize_shortest_edge_dims(375, 1242, cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.INPUT.RESIZE.MAX_SIZE_TEST)
    for name in pred_pngs:
        if read_image_bgr(os.path.join(vis, name)).shape != (*test_hw, 3):
            raise AssertionError(f"phase19: {name} is not the {test_hw} network input")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tests = [r for r in rows if "total_loss" not in r]
    if [r["step"] for r in tests] != [VIS_STEPS] * 2 or CAR_AP3D not in tests[0] or not np.isfinite(
            tests[1].get("tta/" + CAR_AP3D, np.nan)):
        raise AssertionError(f"phase19: the final tests in metrics.jsonl: {[sorted(r)[:3] for r in tests]}")
    log(f"phase19 CLI ({res['seconds']:.1f} s, {VIS_STEPS} steps, the final test plain then TTA): "
        f"{len(loader_pngs)} dataloader drawings, each drawn at all {n_boxes} of its ground-truth boxes; "
        f"{len(pred_pngs)} prediction drawings at {test_hw}; {CAR_AP3D} {tests[0][CAR_AP3D]:.4f}, tta/ "
        f"{tests[1]['tta/' + CAR_AP3D]:.4f}")

    pred_dir, pred_json = os.path.join(tmp, "predict_vis"), os.path.join(tmp, "predict_vis.json")
    proc, seconds = children["predict"]
    if proc.returncode != 0:
        raise AssertionError(f"phase19: predict --vis exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(pred_json) as f:
        records = json.load(f)
    empty_bev = BEVImage().data
    n_det = 0
    for rec in records:
        frame = read_image_bgr(rec["file_name"])
        drawn = read_image_bgr(os.path.join(pred_dir, rec["image_id"] + ".png"))
        bev = read_image_bgr(os.path.join(pred_dir, rec["image_id"] + "_bev.png")) if rec["quat"] else None
        n_det += len(rec["scores"])
        if drawn.shape != frame.shape or any(not drawn_inside(drawn, frame, b) for b in rec["boxes2d"]):
            raise AssertionError(f"phase19: predict --vis {rec['image_id']} is not drawn at its boxes")
        if bev is not None and (bev.shape != empty_bev.shape or np.array_equal(bev, empty_bev)):
            raise AssertionError(f"phase19: predict --vis {rec['image_id']}_bev.png is empty")
    if n_det == 0 or len(os.listdir(pred_dir)) != len(records) + sum(bool(r["quat"]) for r in records):
        raise AssertionError(f"phase19: predict --vis: {n_det} detections, files {sorted(os.listdir(pred_dir))}")
    log(f"phase19 predict --vis ({seconds:.1f} s): {len(records)} frames, {n_det} detections at score >= 0.3 from "
        f"the overfit checkpoint, each frame drawn at its boxes, BEV images drawn")

    loader_dir = os.path.join(tmp, "loader_vis")
    n_vis = VIS_LOADER_IMAGES
    proc, seconds = children["loader"]
    if proc.returncode != 0:
        raise AssertionError(f"phase19: visualize_dataloader exited {proc.returncode}: {proc.stderr[-2000:]}")
    loader = build_train_dataloader(cfg, batch_size=1, num_workers=1)
    rng = np.random.RandomState(0)  # the CLI's sample stream
    n_boxes = 0
    for i, d in enumerate(loader.dataset_dicts[:n_vis]):
        sample = loader.mapper(d, rng)
        d2 = read_image_bgr(os.path.join(loader_dir, f"{i:04d}_D2DataloaderVisualizer.png"))
        box3d = read_image_bgr(os.path.join(loader_dir, f"{i:04d}_Box3DDataloaderVisualizer.png"))
        h, w = sample["image"].shape[:2]
        if d2.shape != sample["image"].shape or any(not drawn_inside(d2, sample["image"], b)
                                                    for b in sample["gt_boxes2d"]):
            raise AssertionError(f"phase19: visualize_dataloader sample {i}: the 2D drawing")
        side = (max(h, 1000) + 2, max(w, 1000) + 2)
        n_gt = len(sample["gt_classes"])
        n_boxes += n_gt
        if box3d.shape != (side[0], 2 * side[1], 3) or n_gt and (np.array_equal(
                box3d[:1000, side[1]:side[1] + 1000], empty_bev) or np.array_equal(box3d[:h, :w], sample["image"])):
            raise AssertionError(f"phase19: visualize_dataloader sample {i}: the 3D drawing {box3d.shape}")
    if n_boxes == 0:
        raise AssertionError("phase19: visualize_dataloader drew no box")
    log(f"phase19 visualize_dataloader: {n_vis} samples x 2 visualizers, drawn at their {n_boxes} boxes "
        f"({seconds:.1f} s) on {card}")
    log("phase19 ok")
    return res


def zero_launches():
    """Set the launch count of every kernel wrapper to 0."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same
    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_grouped
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_scan
    from dd3d_tpu_torch.ops.quantize import quantize_int8
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    for k in (greedy_nms, greedy_nms_scan, quantize_int8, int8_conv, int8_conv_grouped, conv_dw_s1_same, stem_conv):
        k.launches = 0
    int8_conv.launches_by_out.update(dict.fromkeys(int8_conv.launches_by_out, 0))
    int8_conv_grouped.launches_by_route.update(dict.fromkeys(int8_conv_grouped.launches_by_route, 0))


def phase20_tta(tmp, overfit_dir, device, card):
    """Test-time augmentation at full width on the overfit checkpoint, over
    TTA_IMAGES frames of the fixture (one chunk, five canvas buckets of
    2 x TTA_IMAGES instances up to 640x1920): (a) EVAL_ONLY through the
    CLI's main with the experiment's own TEST.AUG, bf16: the plain test,
    then the TTA test;
    (b) the TTA test in static int8 (bench.py's overrides, calibrated per
    bucket); (c) on TTA_CHECK_IMAGES frames, int8 TTA through the kernels and
    through their plain versions: identical detections and results; (d) a
    witness for (a)'s tta/ AP: bf16 TTA at the checkpoint's one training
    scale, 384, without and with the flip, and at the five scales without
    it, beside the plain test; the int8 conv kernel against its plain
    version at the largest bucket's shapes. The launch counts of each TTA
    pass are set to 0 just before it and read just after. Returns the
    phase's numbers."""
    import dd3d_tpu_torch.train as train_mod
    from dd3d_tpu_torch.data.augmentations import resize_shortest_edge_dims
    from dd3d_tpu_torch.data.catalog import DatasetCatalog
    from dd3d_tpu_torch.data.imageio import read_image_bgr, resize_bilinear
    from dd3d_tpu_torch.evaluators import get_evaluator
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models import tta as tta_mod
    from dd3d_tpu_torch.overfit_smoke import kernel_launches, make_fixture
    from dd3d_tpu_torch.training.checkpoint import load_weights

    t0 = time.time()
    root = make_fixture(os.path.join(tmp, "fixture_tta"), n_images=TTA_IMAGES)
    ckpt = os.path.join(overfit_dir, "ckpt")
    log(f"phase20 fixture of {TTA_IMAGES} frames written in {time.time() - t0:.1f} s")
    passes, instances = [], []
    real_pass, real_infer = train_mod._do_test_tta, tta_mod.DD3DWithTTA.infer_batch

    def measured_pass(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        out = real_pass(*args, **kwargs)
        torch.cuda.synchronize()
        passes.append({"seconds": time.perf_counter() - t, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "launches": kernel_launches(), "results": out})
        return out

    def recorded_infer(self, images, intrinsics):
        instances.append(self)
        return real_infer(self, images, intrinsics)

    train_mod._do_test_tta, tta_mod.DD3DWithTTA.infer_batch = measured_pass, recorded_infer
    try:
        out_dir = train_mod.main(["+experiments=dd3d_kitti_dla34_overfit", "EVAL_ONLY=True", f"MODEL.CKPT={ckpt}",
                                  f"DATASET_ROOT={root}", "DATASETS.TEST.NAME=kitti_3d_train",
                                  f"OUTPUT_ROOT={os.path.join(tmp, 'out_tta')}"])
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        bf16 = passes[-1]
        tta = instances[-1]
        buckets = {f"{h}x{w}": n for (h, w), n in tta.stats["buckets"].items()}
        seconds = {k: round(v, 3) for k, v in tta.stats["seconds"].items()}
        plain_ap, tta_ap = rows[0].get(CAR_AP3D, np.nan), rows[1].get("tta/" + CAR_AP3D, np.nan)
        log(f"phase20(a) EVAL_ONLY, bf16, {TTA_IMAGES} frames on {card}: TTA pass {bf16['seconds']:.2f} s, "
            f"{TTA_IMAGES / bf16['seconds']:.2f} images/s (frames read, resized, forward, merge, evaluators); "
            f"buckets (instances) {buckets}; host seconds by part {seconds}; peak {bf16['peak_gib']:.2f} GiB; "
            f"kernel launches in the TTA pass {bf16['launches']}; {CAR_AP3D} plain {plain_ap:.4f}, tta/ {tta_ap:.4f}; "
            f"BEV plain {rows[0].get('kitti_3d/kitti_bev_r40/Car_Moderate_0.5', np.nan):.4f}, tta/ "
            f"{rows[1].get('tta/kitti_3d/kitti_bev_r40/Car_Moderate_0.5', np.nan):.4f}")
        if [r["step"] for r in rows] != [rows[0]["step"]] * 2 or not (np.isfinite(plain_ap) and np.isfinite(tta_ap)):
            raise AssertionError("phase20(a): metrics.jsonl does not hold the plain then the tta/ results")
        if list(buckets.values()) != [2 * TTA_IMAGES] * len(TTA_BUCKETS) or list(buckets) != list(TTA_BUCKETS):
            raise AssertionError(f"phase20(a): buckets {buckets}")
        vis = os.path.join(out_dir, "visualization")
        preds = sorted(os.listdir(vis))
        cfg_a = loader_cfg(root)
        gt = {d["image_id"]: d for d in DatasetCatalog.get("kitti_3d_train")}
        drawn = 0
        for name in preds:  # pred_<image_id>.png of the first 8 frames, the overfit run's training set
            d = gt[name[len("pred_"):-len(".png")]]
            h, w = resize_shortest_edge_dims(d["height"], d["width"], cfg_a.INPUT.RESIZE.MIN_SIZE_TEST,
                                             cfg_a.INPUT.RESIZE.MAX_SIZE_TEST)
            undrawn = resize_bilinear(read_image_bgr(d["file_name"]), h, w)
            img = read_image_bgr(os.path.join(vis, name))
            s = h / d["height"]
            drawn += img.shape == undrawn.shape and all(
                drawn_inside(img, undrawn, np.asarray(a["bbox"]) * s, margin=6) for a in d["annotations"])
        if len(preds) != min(8, TTA_IMAGES) or drawn == 0:
            raise AssertionError(f"phase20(a): prediction drawings {preds}, {drawn} drawn at their cars")
        log(f"phase20(a) EVAL_ONLY wrote {len(preds)} prediction drawings at {h}x{w}, {drawn} of them drawn at "
            "their ground-truth cars (boxes at score >= 0.3)")

        cfg8 = loader_cfg(root, **{"DATASETS.TEST.NAME": "kitti_3d_train", "TPU.QUANT_INT8": True,
                                   "TPU.QUANT_MIN_CH": 32, "TPU.QUANT_UNFOLDED": True})
        model = build_model(cfg8, generator=torch.Generator().manual_seed(SEED))
        step = load_weights(model, ckpt)
        model = model.to(device)
        train_mod.do_test(cfg8, model, os.path.join(tmp, "out_tta_int8"), step=step, use_tta=True)
        int8, tta8 = passes[-1], instances[-1]
        kitti_b = {k: v for k, v in train_mod.flatten_results(bf16["results"]).items() if "/kitti_3d/" in k}
        kitti_i = {k: v for k, v in train_mod.flatten_results(int8["results"]).items() if "/kitti_3d/" in k}
        dap = max(abs(kitti_i[k] - kitti_b[k]) for k in kitti_b)
        calibrated = [f"{h}x{w}" for h, w in tta8.stats["calibrated"]]
        log(f"phase20(b) static int8 TTA, {TTA_IMAGES} frames on {card}: {int8['seconds']:.2f} s, "
            f"{TTA_IMAGES / int8['seconds']:.2f} images/s; calibrated buckets {calibrated} "
            f"(host seconds by part {({k: round(v, 3) for k, v in tta8.stats['seconds'].items()})}); scale misses "
            f"{len(tta8.quant.misses)}; peak {int8['peak_gib']:.2f} GiB; kernel launches {int8['launches']}; "
            f"tta/ {CAR_AP3D} {kitti_i['tta/' + CAR_AP3D]:.4f} against bf16 {kitti_b['tta/' + CAR_AP3D]:.4f}; "
            f"worst |dAP| over the {len(kitti_b)} KITTI metrics {dap:.4f}")
        if tta8.quant.misses or calibrated != list(buckets):
            raise AssertionError(f"phase20(b): {len(tta8.quant.misses)} scale misses, calibrated {calibrated}")
        if int8["launches"]["quantize_int8"] == 0 or int8["launches"]["int8_conv"] == 0:
            raise AssertionError(f"phase20(b): the int8 kernels did not launch: {int8['launches']}")
        if not np.isfinite(dap):
            raise AssertionError("phase20(b): an AP is not finite")
    finally:
        train_mod._do_test_tta, tta_mod.DD3DWithTTA.infer_batch = real_pass, real_infer

    dicts = DatasetCatalog.get("kitti_3d_train")[:TTA_CHECK_IMAGES]
    images = [read_image_bgr(d["file_name"]) for d in dicts]
    ks = [np.asarray(d["intrinsics"], np.float64).reshape(3, 3) for d in dicts]
    arms = {}
    for arm, plain in (("kernel", False), ("plain", True)):
        wrapper = tta_mod.DD3DWithTTA(cfg8, model, int8_plain=plain)
        zero_launches()
        t = time.perf_counter()
        merged = wrapper.infer_batch(images, ks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        dets = [{"image_id": d["image_id"], **m} for d, m in zip(dicts, merged)]
        evaluators = get_evaluator(cfg8, "kitti_3d_train")
        for ev in evaluators:
            ev.reset()
            ev.process(dets)
        results = {}
        for ev in evaluators:
            results.update(ev.evaluate() or {})
        arms[arm] = (dets, results, kernel_launches(), seconds, len(wrapper.quant.misses))
    (dk, rk, lk, sk, mk), (dp, rp, lp, sp, mp) = arms["kernel"], arms["plain"]
    log(f"phase20(c) int8 TTA on {TTA_CHECK_IMAGES} frames, kernels against plain versions: detections identical "
        f"{same_detections(dk, dp)} ({sum(len(d['scores']) for d in dk)} merged), results identical "
        f"{same_results(rk, rp)}; launches {lk} / {lp}; {sk:.2f} s / {sp:.2f} s; scale misses {mk} / {mp}")
    if not (same_detections(dk, dp) and same_results(rk, rp)):
        raise AssertionError("phase20(c): int8 TTA through the kernels and through the plain versions differ")
    if lk["int8_conv"] == 0 or lk["quantize_int8"] == 0 or lp["int8_conv"] or lp["quantize_int8"] or mk or mp:
        raise AssertionError(f"phase20(c): launches {lk} / {lp}, misses {mk} / {mp}")
    del model
    witness = phase20_tta_witness(root, ckpt, {"plain": plain_ap, "tta": tta_ap}, device, card)
    conv = phase20_int8_conv_largest_bucket(device, card)
    log("phase20 ok")
    return {"witness": witness, "bf16_images_per_s": TTA_IMAGES / bf16["seconds"], "int8_images_per_s": TTA_IMAGES / int8["seconds"],
            "buckets": buckets, "peak_gib": bf16["peak_gib"], "int8_peak_gib": int8["peak_gib"], "dap": dap,
            "plain_ap": plain_ap, "tta_ap": tta_ap, "bf16_launches": bf16["launches"],
            "int8_launches": int8["launches"], "conv": conv}


def phase20_tta_witness(root, ckpt, ap3d, device, card):
    """Phase 20(d): the bf16 TTA test over the same TTA_IMAGES frames and
    checkpoint at TEST.AUG.MIN_SIZES [384] (the one scale the checkpoint
    trained at, and the plain test's) without and with the flip, and at
    the experiment's five scales without it; each arm's tta/ AP3D@0.5 and
    BEV@0.5 beside (a)'s plain and five-scale-with-flip ones. The arms
    separate the flip and the scales in (a)'s tta/ AP."""
    import dd3d_tpu_torch.train as train_mod
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.training.checkpoint import load_weights

    cfg = loader_cfg(root, **{"DATASETS.TEST.NAME": "kitti_3d_train"})
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    step = load_weights(model, ckpt)
    model = model.to(device)
    bev = CAR_AP3D.replace("kitti_box3d_r40", "kitti_bev_r40")
    arms = {}
    for name, min_sizes, flip in (("384", [384], False), ("384+flip", [384], True),
                                  ("5 scales", list(cfg.TEST.AUG.MIN_SIZES), False)):
        cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.FLIP = min_sizes, flip
        flat = train_mod.flatten_results(train_mod.do_test(cfg, model, None, step=step, use_tta=True))
        arms[name] = (flat["tta/" + CAR_AP3D], flat["tta/" + bev])
    log(f"phase20(d) bf16 TTA arms over {TTA_IMAGES} frames on {card}, Car Moderate AP3D@0.5 / BEV@0.5: "
        + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in arms.items())
        + f"; (a): plain {ap3d['plain']:.4f}, 5 scales+flip {ap3d['tta']:.4f} (AP3D)")
    if not all(np.isfinite(v) for ab in arms.values() for v in ab):
        raise AssertionError(f"phase20(d): an AP is not finite: {arms}")
    del model
    torch.cuda.empty_cache()
    return arms


def phase20_int8_conv_largest_bucket(device, card):
    """The int8 conv kernel at the largest TTA bucket of a full chunk of 80
    frames (160 x 640 x 1920):
    the P3 tower conv (160, 80, 240, 256) -> 256 3x3 against its plain
    version (accumulators exactly, the bf16 epilogue bit for bit), timed
    beside cuDNN's bf16 conv and its bound; and level0's 3x3 16 -> 16 at full
    resolution (3.1e9 input elements, past the kernel's 2^31: launched on two
    runs of 80 images) against the plain version on the runs' edge images."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv, int8_conv_acc_plain

    gen = torch.Generator().manual_seed(SEED + 20)
    on_card = torch.Generator(device=device).manual_seed(SEED + 20)  # the two large inputs, drawn where they lie
    b = LARGEST_BUCKET
    xq = torch.randint(-127, 128, (b, 80, 240, 256), generator=on_card, dtype=torch.int8, device=device)
    wq = torch.randint(-127, 128, (256, 3, 3, 256), generator=gen, dtype=torch.int8).to(device)
    scale = (torch.rand(256, generator=gen) * 1e-3 + 1e-5).to(device)
    bias = torch.randn(256, generator=gen).to(device)
    acc = int8_conv_acc_plain(xq, wq, 1, 1)
    ones = torch.ones(256, device=device)
    got_acc = int8_conv(xq, wq, ones, None, 1, 1, torch.float32)
    if int(acc.abs().max()) >= 2 ** 24 or not torch.equal(got_acc, acc.float()):
        raise AssertionError("phase20: the int8 conv kernel's accumulators differ at the largest bucket's P3 conv")
    del got_acc
    want = dequant_plain(acc, scale, bias, torch.bfloat16)
    del acc
    got = int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"phase20: the int8 conv kernel's bf16 epilogue differs (max {err})")
    del got, want
    torch.cuda.synchronize()
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    k_ms = device_ms(lambda: int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16), 5, prof)
    c_ms = device_ms(cudnn_bf16_conv(xq, wq, 1, 1), 5, prof)
    p_ms = cuda_ms(lambda: dequant_plain(int8_conv_acc_plain(xq, wq, 1, 1), scale, bias, torch.bfloat16), 1)
    bnd, by = int8_conv_bound(xq, wq, 1, 1)
    log(f"phase20 int8 conv at the largest bucket's P3 tower conv ({b}, 80, 240, 256) -> 256 3x3 on {card}: "
        f"accumulators and bf16 epilogue equal to the plain version; device time kernel {k_ms:.4f} ms, cuDNN bf16 "
        f"{c_ms:.4f} ms, plain {p_ms:.2f} ms (CUDA events), bound {bnd:.4f} ms by {by} ({bnd / k_ms:.2f} of the "
        f"kernel's time)")
    del xq
    x0 = torch.randint(-127, 128, (b, 640, 1920, 16), generator=on_card, dtype=torch.int8, device=device)
    w0 = torch.randint(-127, 128, (16, 3, 3, 16), generator=gen, dtype=torch.int8).to(device)
    s0 = (torch.rand(16, generator=gen) * 1e-3 + 1e-5).to(device)
    before = int8_conv.launches
    out0 = int8_conv(x0, w0, s0, None, 1, 1, torch.bfloat16)
    runs = int8_conv.launches - before
    for i in (0, b // 2 - 1, b // 2, b - 1):
        ref = dequant_plain(int8_conv_acc_plain(x0[i:i + 1], w0, 1, 1), s0, None, torch.bfloat16)
        if not torch.equal(out0[i:i + 1], ref):
            raise AssertionError(f"phase20: the int8 conv split over 2^31 elements differs at image {i}")
    log(f"phase20 int8 conv at level0 of the largest bucket ({b}, 640, 1920, 16) -> 16 3x3: {runs} launches, images "
        f"0, {b // 2 - 1}, {b // 2}, {b - 1} equal to the plain version")
    if runs != 2:
        raise AssertionError(f"phase20: {runs} launches for a {x0.numel()}-element input")
    del x0, out0
    torch.cuda.empty_cache()
    return {"ms": k_ms, "cudnn_ms": c_ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by, "max_abs_err": err}


# --- dd3d_kitti_v99: V-99-eSE + FPN 256 + P3-P6 at full width and depth (phases 21-24)

V99 = "dd3d_kitti_v99"
V99_TRAIN_STEPS = 8  # phase 23's timed steps
V99_CLI_STEPS = 4  # phase 24's CLI run


def v99_cfg(**overrides):
    return experiment_cfg(V99, **overrides)


def damp_identity_blocks(model, factor=0.1):
    """Scale the concat norm's affine of every OSA block that adds its input
    back by `factor`, in place. With He-initialized convs each such block
    doubles its input's spread, ~2^13 over V-99's 13 of them, and the first
    train step's gradient norm overflows f32; a trained checkpoint has no
    such growth, and at 0.1 the trunk keeps features of order one."""
    from dd3d_tpu_torch.models.vovnet import OSAModule

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, OSAModule) and m.identity:
                m.concat.norm.weight.mul_(factor)
                m.concat.norm.bias.mul_(factor)
    return model


def build_damped_models():
    """Make `build_model` damp the OSA identity blocks of the models it
    builds, in this process (phase 24's training CLI, which builds its own)."""
    import dd3d_tpu_torch.models as models

    real = models.build_model
    models.build_model = lambda cfg, generator=None: damp_identity_blocks(real(cfg, generator))


def v99_int8_cfg():
    """scripts/bench_v99.py:20-28's serving configuration: static int8 with
    QUANT_MIN_CH 32 (the predictors stay in bf16: no QUANT_UNFOLDED)."""
    return v99_cfg(**{"TPU.QUANT_INT8": True, "TPU.QUANT_MIN_CH": 32})


def serving_profile(infer, images, intrinsics, reps=3):
    """(device ms a batch, kernel launches a batch) of `infer` under the
    profiler, over `reps` batches after one outside it."""
    from torch.profiler import ProfilerActivity, profile

    infer(images[0], intrinsics)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            infer(images[i % len(images)], intrinsics)
        torch.cuda.synchronize()
    kernels = device_rows(prof)
    busy = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) for e in kernels)
    return busy / 1e3 / reps, sum(e.count for e in kernels) / reps


def phase21_v99_serve(device, images, intrinsics, card):
    """bf16 serving of dd3d_kitti_v99 at batch 8, 384x1280, weights from
    randomize_state: phase 2's checks (shapes, finiteness, NMS candidates,
    launches), phase 3's (the NMS kernel and the plain suppression give
    identical detections), phase 4's (fp32 on the card within 1e-3 of the
    CPU's, at batch 1, 384x1280), and images/s, ms a batch, the profiler's
    device time and launches a batch, and peak memory. Returns (model, cfg,
    NMS launches, images/s)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    t0 = time.time()
    cfg = v99_cfg()
    model = build(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase21 {V99}: {cfg.FE.BACKBONE.NAME}, FPN {cfg.FE.FPN.OUT_CHANNELS}, levels {model.strides}, "
        f"{n_params / 1e6:.2f} M parameters, built in {time.time() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    launches, _ = phase2_serve(cfg, model, images, intrinsics, phase="phase21")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase3_plain_path(cfg, model, images, intrinsics, phase="phase21")
    phase4_fp32(v99_cfg(), device, shape=(1, HEIGHT, WIDTH), phase="phase21")
    infer = get_inference_fn(model, cfg)
    med, p25, p75 = serving_ms(infer, images, intrinsics)
    dev_ms, n_kernels = serving_profile(infer, images, intrinsics)
    log(f"phase21 timing on {card}: bf16 serving, batch {BATCH} {HEIGHT}x{WIDTH}: median {med:.3f} ms/batch "
        f"(p25 {p25:.3f}, p75 {p75:.3f}) = {BATCH / med * 1e3:.2f} images/s; profiler: {dev_ms:.3f} ms of device "
        f"time and {n_kernels:.0f} kernel launches a batch (device busy {dev_ms / med:.3f} of the host's ms); "
        f"peak memory {peak:.2f} GiB; NMS kernel launches {launches}")
    log(f"phase21 ok ({time.time() - t0:.2f} s)")
    return model, cfg, launches, BATCH / med * 1e3


V99_QUANT_SHAPE = (BATCH, HEIGHT // 4, WIDTH // 4, 768)  # stage 2's concat input, the largest int8 activation


def phase22_v99_int8(model, bf16_cfg, images, intrinsics, device, card):
    """Static int8 of dd3d_kitti_v99 in scripts/bench_v99.py's settings, with
    scales from 2 batches: phase 7 at every distinct int8 conv site of this
    path (bit for bit), the quantize kernel against its plain version at
    stage 2's concat input, phase 8's path checks (launches, no scale miss,
    kernel and plain int8 detections identical, drift against bf16), int8
    against bf16 in turns in images/s, and the int8 sites summed against
    cuDNN's bf16 conv and the bound. Returns (launches by kernel, max error
    of the conv sites, of the quantize check, images/s {int8, bf16}, sums)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    t0 = time.time()
    conv_err, sites, cases, _ = phase7_int8_conv(model, images[0], unfolded=False, phase="phase22")
    gen = torch.Generator().manual_seed(SEED + 21)
    x = (torch.randn(V99_QUANT_SHAPE, generator=gen) * 3).to(device, torch.bfloat16)
    quant_err = 0.0
    for scale in (x.float().abs().amax() / 127, torch.tensor(0.5)):
        xs = scale.reshape(1).float().to(device)
        got, want = quantize_int8(x, xs), quantize_int8_plain(x, xs)
        quant_err = max(quant_err, float((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"phase22: the quantize kernel and its plain version differ at {V99_QUANT_SHAPE}")
    log(f"phase22 quantize kernel at {V99_QUANT_SHAPE} bf16, dynamic and static scales: equal to the plain version")
    cfg8, launches = phase8_int8_path(bf16_cfg, model, images, intrinsics, sites, base_cfg=v99_int8_cfg(),
                                      phase="phase22")
    paths = {"int8": get_inference_fn(model, cfg8), "bf16": get_inference_fn(model, bf16_cfg)}
    runs = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        runs[name].append(serving_ms(paths[name], images, intrinsics)[0])
    ips = {name: BATCH / (np.mean(ms) / 1e3) for name, ms in runs.items()}
    log(f"phase22 timing on {card}: serving in turns (int8, bf16, bf16, int8), median ms/batch int8 "
        f"{runs['int8'][0]:.3f} / {runs['int8'][1]:.3f}, bf16 {runs['bf16'][0]:.3f} / {runs['bf16'][1]:.3f}: "
        f"static int8 {ips['int8']:.2f} images/s, bf16 {ips['bf16']:.2f} images/s")
    sums = int8_conv_sites_timing(cases, cfg8.TPU.QUANT_MIN_CH, phase="phase22")
    launches["fusion"] = fusion_ab(model, cfg8, images, intrinsics, "phase22", card)
    log(f"phase22 ok ({time.time() - t0:.2f} s)")
    return launches, conv_err, quant_err, ips, sums


def phase23_v99_train(device, card):
    """The bf16 train step of dd3d_kitti_v99 at batch 8, 384x1280, on seeded
    synthetic batches (He-initialized convs, seeded norm statistics, the
    identity blocks damped):
    finite losses, ms a step over V99_TRAIN_STEPS timed steps, peak memory,
    the profiler's launches and device time a step."""
    from dd3d_tpu_torch.training.train_loop import to_device

    t0 = time.time()
    cfg = v99_cfg()
    batches = [to_device(b, device) for b in train_batches(cfg, 3, BATCH, HEIGHT, WIDTH, SEED + 23)]
    metrics, (med, p25, p75), peak, dev_ms, busy, n_kernels = timed_train_steps(
        cfg, damp_identity_blocks(build_train_model(cfg, "cpu")), batches, V99_TRAIN_STEPS, device, "phase23")
    log("phase23 total loss by step: " + ", ".join(f"{m['total_loss']:.3f}" for m in metrics))
    log(f"phase23 timing on {card}: {V99} bf16 train step, batch {BATCH} {HEIGHT}x{WIDTH}: median {med:.2f} ms "
        f"(p25 {p25:.2f}, p75 {p75:.2f}) over {V99_TRAIN_STEPS} steps = {BATCH / med * 1e3:.2f} images/s; peak "
        f"memory {peak:.2f} GiB; profiler "
        f"over {len(batches)} steps: {dev_ms:.2f} ms of device time a step, busy share {busy:.3f}, "
        f"{n_kernels:.0f} kernel launches a step")
    log(f"phase23 ok ({time.time() - t0:.2f} s)")
    return med, peak


def v99_children(tmp):
    """Phase 24's children on a fixture of its own: the training CLI, then
    EVAL_ONLY, `predict` and `calibrate_int8` from its checkpoint at once."""
    from concurrent.futures import ThreadPoolExecutor

    from dd3d_tpu_torch.data.imageio import write_png
    from dd3d_tpu_torch.overfit_smoke import make_fixture

    root = make_fixture(os.path.join(tmp, "v99_fixture"), n_images=8)
    frames = os.path.join(tmp, "v99_frames")
    os.makedirs(frames, exist_ok=True)
    write_png(os.path.join(frames, "000000.png"),
              np.random.RandomState(SEED + 24).randint(0, 256, (375, 1200, 3)).astype(np.uint8))
    out = {"root": root, "frames": frames}
    data = [f"DATASET_ROOT={root}", "DATASETS.TEST.NAME=kitti_3d_train", "SOLVER.IMS_PER_BATCH=8"]
    out["train"] = cli_child("--cli-rank", [
        f"+experiments={V99}", *data, f"OUTPUT_ROOT={os.path.join(tmp, 'v99_out')}", f"SOLVER.MAX_ITER={V99_CLI_STEPS}",
        f"SOLVER.CHECKPOINT_PERIOD={V99_CLI_STEPS}", "TEST.EVAL_PERIOD=0", "VIS.DATALOADER_ENABLED=False",
        "TPU.PALLAS_STEM_DW=True", THREAD_LOADER])
    trained = cli_output(out["train"])
    if trained is None:
        return out
    ckpt = os.path.join(trained["output_dir"], "ckpt")
    common = ["--experiment", V99, "--images", frames, "--intrinsics", KITTI_INTRINSICS, "--ckpt", ckpt]
    with ThreadPoolExecutor(3) as pool:
        ev = pool.submit(cli_child, "--eval-only", [
            f"+experiments={V99}", "EVAL_ONLY=True", f"MODEL.CKPT={ckpt}", *data[:2],
            "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0", f"OUTPUT_ROOT={os.path.join(tmp, 'v99_eval')}"])
        predict = pool.submit(run_child, ["-m", "dd3d_tpu_torch.predict", *common, "--out",
                                          os.path.join(tmp, "v99_predictions.json")])
        calibrate = pool.submit(run_child, ["-m", "dd3d_tpu_torch.calibrate_int8", *common, "--out",
                                            os.path.join(tmp, "v99_scales.json")])
        out.update(eval=ev.result(), predict=predict.result(), calibrate_int8=calibrate.result())
    return out


def phase24_v99_clis(tmp, device, card, children):
    """The CLIs under dd3d_kitti_v99 on the port's fixture (8 frames): the
    training CLI for V99_CLI_STEPS steps of batch 8 (its model's identity
    blocks damped as phase 23's; the resize buckets,
    TPU.PALLAS_STEM_DW on, which launches nothing on this trunk), EVAL_ONLY
    from its checkpoint, then inference_on_dataset through the NMS kernel
    and with the plain suppression (identical detections and results);
    `predict` on a 375x1200 frame, whose canvas is 384x1280 as in JAX; and
    `calibrate_int8`; the children are v99_children's. Returns (NMS launches
    of EVAL_ONLY)."""
    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.predict import iter_batches, read_image_dicts
    from dd3d_tpu_torch.training.checkpoint import CheckpointManager, load_weights

    t0 = time.time()
    root, frames = children["root"], children["frames"]
    res = cli_result("--cli-rank", children["train"])
    ckpt = os.path.join(res["output_dir"], "ckpt")
    buckets = sorted({tuple(s[1:3]) for s in res["shapes"]})
    log(f"phase24 train CLI: {len(res['shapes'])} steps of batch 8 in {res['seconds']:.1f} s (process start and "
        f"model included), canvases {buckets}, losses " + ", ".join(f"{v:.3f}" for v in res["losses"])
        + f"; dW kernel launches {res['dw_launches']}; checkpoints {CheckpointManager(ckpt).steps()}")
    if len(res["losses"]) != V99_CLI_STEPS or not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"phase24: {len(res['losses'])} steps of {V99_CLI_STEPS}, or a loss not finite")
    if res["dw_launches"] != 0 or CheckpointManager(ckpt).steps() != [V99_CLI_STEPS]:
        raise AssertionError("phase24: the dW kernel launched on VoVNet, or no checkpoint")

    overrides = {"DATASET_ROOT": root, "DATASETS.TEST.NAME": "kitti_3d_train",
                 "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH": 0.0}
    ev = cli_result("--eval-only", children["eval"])
    with open(os.path.join(ev["output_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    log(f"phase24 EVAL_ONLY CLI ({ev['seconds']:.1f} s): NMS kernel launches {ev['nms_launches']}, {CAR_AP3D} = "
        f"{rows[-1].get(CAR_AP3D, float('nan')):.4f}")
    if ev["nms_launches"] < 1 or len(rows) != 1 or not np.isfinite(rows[0].get(CAR_AP3D, np.nan)):
        raise AssertionError("phase24: the EVAL_ONLY CLI did not launch the NMS kernel or log its results")
    cfg = v99_cfg(**overrides)
    register_datasets(cfg)
    loader = build_test_dataloader(cfg, dataset_name=cfg.DATASETS.TEST.NAME)
    model = build_model(cfg)
    load_weights(model, ckpt)
    kernel_and_plain(model.to(device), cfg, loader, "phase24")

    (_, batch, _), = iter_batches(cfg, read_image_dicts([os.path.join(frames, "000000.png")],
                                                        np.asarray(KITTI_K, np.float64)), 1)
    if batch["image"].shape != (1, 384, 1280, 3):
        raise AssertionError(f"phase24: a 375x1200 frame gives a {batch['image'].shape} batch, not 384x1280")
    out = os.path.join(tmp, "v99_predictions.json")
    scales = os.path.join(tmp, "v99_scales.json")
    for name in ("predict", "calibrate_int8"):
        proc, seconds = children[name]
        if proc.returncode != 0:
            raise AssertionError(f"phase24 {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        log(f"phase24 {name} CLI ({seconds:.1f} s): " + proc.stdout.strip().splitlines()[-1][:200])
    with open(out) as f:
        records = json.load(f)
    with open(scales) as f:
        keys = json.load(f)
    boxes = np.asarray(records[0]["boxes2d"]).reshape(-1, 4)
    if len(records) != 1 or not len(boxes) or boxes[:, 2].max() > 1200 or boxes[:, 3].max() > 375:
        raise AssertionError("phase24: predict's detections are missing or lie outside the 1200x375 frame")
    tags = keys.get("backbone/bottom_up/OSA5_3/concat/conv", {})
    if "12x40x2144" not in tags or any("top_p6" in k or "ese" in k for k in keys):
        raise AssertionError(f"phase24: calibrate_int8 wrote {len(keys)} convs, OSA5_3's concat at {list(tags)}")
    log(f"phase24 ok ({time.time() - t0:.2f} s): predict on a 384x1280 canvas ({len(boxes)} detections), "
        f"calibrate_int8 {len(keys)} convs")
    return ev["nms_launches"]


NUSC = "dd3d_nusc_dla34"
NUSC_V99 = "dd3d_nusc_v99"
NUSC_HW = (900, 1600)  # nuScenes camera frames
NUSC_K = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]]  # a nuScenes front camera's
NUSC_BATCH, NUSC_N_BATCHES = 12, 3  # two samples of 6 cameras a batch
NUSC_POSE_TVEC = ((10.0, -2.0, 1.5), (-4.0, 7.0, 1.5))  # the two samples' camera -> global translations
NUSC_SAMPLES = 8  # phase 27-28's fixture: 48 frames
NUSC_TTA_SIZES = [640, 896]  # phase 27's TTA scales, cut from the experiment's five (640-1152)
NUSC_TRAIN_STEPS, NUSC_TRAIN_BATCH, NUSC_TRAIN_SIZE = 4, 8, 896
NUSC_NDS = "nuscenes/NDS"
# f32 operations of the scan's work on these inputs: a compare of every
# pair (the pack), and an OR of a word for each kept row (the walk)
SCAN_OPS_PER_PAIR = 1


def nusc_batches(cfg, device):
    """NUSC_N_BATCHES batches of NUSC_BATCH frames as the test loader makes
    them: synthetic 900x1600 uint8 frames resized by MIN_SIZE_TEST (the
    port's Pillow-exact resize, intrinsics in f64) onto a zero canvas padded
    to 128. Every camera of a sample is the same frame under the same
    camera -> global pose (identity rotation, NUSC_POSE_TVEC), so the sample
    aggregation has 6 copies of each detection. Returns (images, intrinsics,
    pose_quat, pose_tvec); the last three are shared by every batch."""
    from dd3d_tpu_torch.data.augmentations import ResizeTransform, resize_shortest_edge_dims

    h, w = NUSC_HW
    nh, nw = resize_shortest_edge_dims(h, w, cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.INPUT.RESIZE.MAX_SIZE_TEST)
    ph, pw = -(-nh // 128) * 128, -(-nw // 128) * 128
    rng = np.random.RandomState(SEED + 25)
    images, ks = [], None
    for _ in range(NUSC_N_BATCHES):
        canvas = np.zeros((NUSC_BATCH, ph, pw, 3), np.uint8)
        ks = np.zeros((NUSC_BATCH, 3, 3), np.float32)
        for smp in range(NUSC_BATCH // 6):
            frame = {"image": rng.randint(0, 256, (h, w, 3), dtype=np.uint8), "intrinsics": np.float64(NUSC_K),
                     "boxes2d": np.zeros((0, 4), np.float32), "boxes3d": np.zeros((0, 10))}
            frame = ResizeTransform(h, w, nh, nw)(frame)
            canvas[smp * 6:(smp + 1) * 6, :nh, :nw] = frame["image"]
            ks[smp * 6:(smp + 1) * 6] = frame["intrinsics"].astype(np.float32)
        images.append(torch.from_numpy(canvas).to(device))
    pose_quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * NUSC_BATCH, device=device)
    pose_tvec = torch.tensor([NUSC_POSE_TVEC[i // 6] for i in range(NUSC_BATCH)], device=device)
    return images, torch.from_numpy(ks).to(device), pose_quat, pose_tvec


def scan_bound(iou, valid, keep):
    """The scan's least time on these inputs: the matrix and valid read once,
    keep written once; a compare a pair (the pack) and an OR of each kept
    row's words (the walk)."""
    b, n = valid.shape
    words = -(-n // 64)
    nbytes = iou.numel() * 4 + valid.numel() + keep.numel()
    return bound_ms(nbytes, SCAN_OPS_PER_PAIR * b * n * n + int(keep.sum()) * words, "f32")


def phase25_nusc_serve(device, card):
    """dd3d_nusc_dla34 bf16 serving at full width (checks in the docstring of
    this file). Returns a dict of launches, timings and the scan's row of
    the kernels line."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms import greedy_suppress
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain, greedy_nms_scan

    t0 = time.time()
    cfg = experiment_cfg(NUSC)
    model = build(cfg, device)
    images, ks, pq, pt = nusc_batches(cfg, device)
    log(f"phase25 {NUSC}: batches of {NUSC_BATCH} (2 samples of 6 cameras) {NUSC_HW[0]}x{NUSC_HW[1]} -> "
        f"{tuple(images[0].shape[1:3])} canvas, DO_BEV_NMS {cfg.DD3D.INFERENCE.DO_BEV_NMS}, NUSC_SAMPLE_AGGREGATE "
        f"{cfg.DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE}, BEV IoU threshold {cfg.DD3D.INFERENCE.BEV_NMS_IOU_THRESH}")
    scans = []

    def recording_scan(iou, valid, thr):
        keep = greedy_nms_scan(iou, valid, thr)
        scans.append((iou.clone(), valid.clone(), thr, keep))
        return keep

    infer = get_inference_fn(model, cfg, group_size=6)
    per_image = get_inference_fn(model, cfg)  # no poses: the images alone, each with its own BEV NMS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    dets = [infer(im, ks, pq, pt) for im in images]  # the main path
    torch.cuda.synchronize()
    launches = {"greedy_nms": greedy_nms.launches, "greedy_nms_scan": greedy_nms_scan.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d = cfg.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
    for i, det in enumerate(dets):
        for k, v in det.items():
            if tuple(v.shape[:2]) != (NUSC_BATCH, d) or (v.is_floating_point() and not torch.isfinite(v).all()):
                raise AssertionError(f"phase25 batch {i}: {k} has shape {tuple(v.shape)} or is not finite")
        alone = per_image(images[i], ks)["valid"].view(2, 6, d).sum(dim=(1, 2)).tolist()
        kept = det["valid"].view(2, 6, d).sum(dim=(1, 2)).tolist()
        log(f"phase25 batch {i}: detections a sample {kept} after the sample aggregation, {alone} without it "
            f"(each camera's own BEV NMS)")
        if not all(0 < a < b for a, b in zip(kept, alone)):
            raise AssertionError(f"phase25: the aggregation does not cut each sample: {kept} against {alone}")
        t_off = det["tvec_global"] - pt[:, None, :]
        if not bool((t_off[det["valid"]][:, 2] > 0).all()):
            raise AssertionError("phase25: a kept global translation is not the pose's plus a camera-frame one")
    if launches != {"greedy_nms": NUSC_N_BATCHES, "greedy_nms_scan": 2 * NUSC_N_BATCHES}:
        raise AssertionError(f"phase25: launches {launches} for {NUSC_N_BATCHES} batches (want 1 NMS and 2 scans "
                             "a batch: the per-image BEV NMS, then the samples')")

    plain = get_inference_fn(model, cfg, group_size=6, suppress=greedy_nms_plain, scan=greedy_suppress)
    scan_err = 0
    for i, im in enumerate(images):
        det_k = get_inference_fn(model, cfg, group_size=6, scan=recording_scan)(im, ks, pq, pt)
        det_p = plain(im, ks, pq, pt)
        torch.cuda.synchronize()
        for k in det_k:
            if not torch.equal(det_k[k], det_p[k]):
                raise AssertionError(f"phase25 batch {i}: {k} differs between the kernel path and the plain path")
    for iou, valid, thr, keep in scans:
        scan_err = max(scan_err, int((keep.int() - greedy_suppress(iou, valid, thr).int()).abs().max()))
    shapes = sorted({tuple(v.shape) for _, v, _, _ in scans})
    log(f"phase25 kernel path against plain path (2D NMS and BEV scan): detections identical over "
        f"{NUSC_N_BATCHES} batches; the scan at {shapes}, max |kernel - plain| = {scan_err} (tolerance 0)")
    if scan_err or shapes != [(2, 6 * d), (NUSC_BATCH, d)]:
        raise AssertionError(f"phase25: scan shapes {shapes}, error {scan_err}")

    med, p25, p75 = serving_ms(lambda im, _k: infer(im, ks, pq, pt), images, None)
    dev_ms, n_kernels = serving_profile(lambda im, _k: infer(im, ks, pq, pt), images, None)
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    scan_t = {}
    for iou, valid, thr, keep in (scans[0], scans[1]):
        key = tuple(valid.shape)
        for _ in range(3):
            greedy_nms_scan(iou, valid, thr)
            greedy_suppress(iou, valid, thr)
        plain_a = cuda_ms(lambda: greedy_suppress(iou, valid, thr), 20)
        dev_a = device_ms(lambda: greedy_nms_scan(iou, valid, thr), 50, prof)
        dev_b = device_ms(lambda: greedy_nms_scan(iou, valid, thr), 50, prof)
        plain_b = cuda_ms(lambda: greedy_suppress(iou, valid, thr), 20)
        bnd, by = scan_bound(iou, valid, keep)
        scan_t[key] = (float(np.mean([dev_a, dev_b])), float(np.mean([plain_a, plain_b])), bnd, by)
        log(f"phase25 BEV scan at {key} on {card}: {dev_a:.4f} / {dev_b:.4f} ms a call of device time (profiler, "
            f"pack + scan), plain greedy_suppress {plain_a:.4f} / {plain_b:.4f} ms (CUDA events, in turns); bound "
            f"{bnd:.6f} ms by {by}; kept {int(keep.sum())} of {int(valid.sum())}")
    log(f"phase25 timing on {card}: bf16 serving with the sample aggregation, batch {NUSC_BATCH} "
        f"{tuple(images[0].shape[1:3])}: median {med:.3f} ms/batch (p25 {p25:.3f}, p75 {p75:.3f}) = "
        f"{NUSC_BATCH / med * 1e3:.2f} images/s; profiler: {dev_ms:.3f} ms of device time and {n_kernels:.0f} "
        f"kernel launches a batch (device busy {dev_ms / med:.3f} of the host's ms); peak memory {peak:.2f} GiB; "
        f"launches on the main path {launches}")

    v99_cfg_ = experiment_cfg(NUSC_V99)
    v99 = build(v99_cfg_, device)
    det = get_inference_fn(v99, v99_cfg_, group_size=6)(images[0], ks, pq, pt)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v.float()).all()) for v in det.values()) or not bool(det["valid"].any()):
        raise AssertionError(f"phase25: {NUSC_V99}'s detections are not finite or empty")
    log(f"phase25 {NUSC_V99} ({v99_cfg_.FE.BACKBONE.NAME}, levels {v99.strides}): one batch served with the "
        f"aggregation, {int(det['valid'].sum())} detections kept, all finite")
    del v99
    torch.cuda.empty_cache()
    log(f"phase25 ok ({time.time() - t0:.2f} s)")
    return {"launches": launches, "images_per_s": NUSC_BATCH / med * 1e3, "dev_ms": dev_ms, "busy": dev_ms / med,
            "peak_gib": peak, "scan": scan_t, "scan_err": scan_err}


def nusc_children(tmp):
    """Phase 28's child on the 6-camera fixture (written here, read by
    phase 27 too): the training CLI."""
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture

    t0 = time.time()
    root = make_nusc_fixture(os.path.join(tmp, "nusc_fixture"), n_samples=NUSC_SAMPLES, height=NUSC_HW[0],
                             width=NUSC_HW[1])
    write_s = time.time() - t0
    return {"root": root, "write_s": write_s, "train": cli_child("--cli-rank", [
        f"+experiments={NUSC}", f"DATASET_ROOT={root}", f"DATASETS.TRAIN.NAME={NUSC_FIXTURE}",
        f"DATASETS.TEST.NAME={NUSC_FIXTURE}", f"OUTPUT_ROOT={os.path.join(tmp, 'nusc_train')}",
        f"SOLVER.MAX_ITER={NUSC_TRAIN_STEPS}", f"SOLVER.IMS_PER_BATCH={NUSC_TRAIN_BATCH}",
        f"SOLVER.CHECKPOINT_PERIOD={NUSC_TRAIN_STEPS}", f"INPUT.RESIZE.MIN_SIZE_TRAIN=[{NUSC_TRAIN_SIZE}]",
        "TPU.PALLAS_STEM_DW=True", "TEST.EVAL_PERIOD=0", "TEST.AUG.ENABLED=False", "VIS.DATALOADER_ENABLED=False",
        THREAD_LOADER], timeout_s=900)}


def phase27_nusc_eval(tmp, device, card, children):
    """The CLI's EVAL_ONLY on the 6-camera fixture (NUSC_SAMPLES samples at
    900x1600, random weights of the CLI's own build, PRE_NMS_THRESH 0),
    in this process through `train.main`: the plain test (the test loader's
    samples, the sample aggregation on the card, nuscenes_evaluator), then
    the TTA test (NuscenesDD3DWithTTA at TEST.AUG.MIN_SIZES cut to
    NUSC_TTA_SIZES with flip, the BEV NMS over each image's merge and the
    host sample aggregation). Checks: finite NDS and mAP in both rows of
    metrics.jsonl, global translations in both submissions equal to the
    fixture's pose plus a camera-frame translation in front of the camera,
    the launch counts of each pass, the BEV NMS over the merge run.
    The fixture is nusc_children's. Returns (plain-pass launches)."""
    import shutil

    import dd3d_tpu_torch.evaluators as evaluators_mod
    import dd3d_tpu_torch.train as train_mod
    from dd3d_tpu_torch.models import tta as tta_mod
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_scan
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, NUSC_FIXTURE_TVEC

    t0 = time.time()
    root = children["root"]
    log(f"phase27 fixture: {NUSC_SAMPLES} samples of 6 cameras, {6 * NUSC_SAMPLES} PNGs at {NUSC_HW[0]}x"
        f"{NUSC_HW[1]}, written in {children['write_s']:.1f} s (beside the other children)")
    passes, timed, ttas, bev_merges = [], [], [], []
    real_test, real_get_evaluator = train_mod.do_test, evaluators_mod.get_evaluator
    real_tta, real_bev = tta_mod.NuscenesDD3DWithTTA, tta_mod.greedy_rotated_nms_np

    def measured_test(cfg, model, output_dir, step=None, use_tta=False):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        out = real_test(cfg, model, output_dir, step=step, use_tta=use_tta)
        torch.cuda.synchronize()
        passes.append({"tta": use_tta, "seconds": time.perf_counter() - t, "nms": greedy_nms.launches,
                       "scan": greedy_nms_scan.launches, "evaluators": [(e.process_s, e.evaluate_s) for e in timed]})
        shutil.copy(os.path.join(output_dir, "nusc_submission.json"),
                    os.path.join(output_dir, f"nusc_submission_{'tta' if use_tta else 'plain'}.json"))
        timed.clear()
        return out

    def timed_get_evaluator(*args, **kwargs):
        evs = [TimedEvaluator(ev) for ev in real_get_evaluator(*args, **kwargs)]
        timed.extend(evs)
        return evs

    class RecordedTTA(real_tta):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            ttas.append(self)

    def counted_bev(*args):
        bev_merges.append(len(args[0]))
        return real_bev(*args)

    train_mod.do_test, evaluators_mod.get_evaluator = measured_test, timed_get_evaluator
    tta_mod.NuscenesDD3DWithTTA, tta_mod.greedy_rotated_nms_np = RecordedTTA, counted_bev
    try:
        out_dir = train_mod.main([f"+experiments={NUSC}", "EVAL_ONLY=True", f"DATASET_ROOT={root}",
                                  f"DATASETS.TEST.NAME={NUSC_FIXTURE}", "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0",
                                  f"TEST.AUG.MIN_SIZES={NUSC_TTA_SIZES}",
                                  f"OUTPUT_ROOT={os.path.join(tmp, 'nusc_eval')}"])
    finally:
        train_mod.do_test, evaluators_mod.get_evaluator = real_test, real_get_evaluator
        tta_mod.NuscenesDD3DWithTTA, tta_mod.greedy_rotated_nms_np = real_tta, real_bev
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    n = 6 * NUSC_SAMPLES
    plain, tta_pass = passes
    tta = ttas[-1]
    for name, row, key in (("plain", rows[0], NUSC_NDS), ("tta", rows[1], "tta/" + NUSC_NDS)):
        mAP = row.get(key.replace("NDS", "mAP"), np.nan)
        log(f"phase27 {name} test: NDS {row.get(key, np.nan):.4f}, mAP {mAP:.4f}")
        if not (np.isfinite(row.get(key, np.nan)) and np.isfinite(mAP)):
            raise AssertionError(f"phase27: the {name} test's NDS or mAP is not finite")
    for name in ("plain", "tta"):
        with open(os.path.join(out_dir, f"nusc_submission_{name}.json")) as f:
            results = json.load(f)["results"]
        entries = [(tok, e) for tok, es in results.items() for e in es]
        offsets = np.asarray([np.asarray(e["translation"]) - NUSC_FIXTURE_TVEC - (int(tok[len("sample"):]), 0, 0)
                              for tok, e in entries])
        log(f"phase27 {name} submission: {len(results)} samples, {len(entries)} detections, the largest sample "
            f"{max(len(es) for es in results.values())}; translation minus the pose: z from "
            f"{offsets[:, 2].min():.2f} to {offsets[:, 2].max():.2f} m")
        if len(results) != NUSC_SAMPLES or not len(entries) or not (offsets[:, 2] > 0).all():
            raise AssertionError(f"phase27: the {name} submission's global translations are not the fixture's pose "
                                 "plus a camera-frame translation in front of the camera")
    batches = -(-n // 96)
    log(f"phase27 plain test on {card}: {plain['seconds']:.2f} s, {n / plain['seconds']:.2f} images/s (loader, "
        f"forward, decode, aggregation, evaluator); nuscenes_evaluator process {plain['evaluators'][0][0]:.3f} s, "
        f"evaluate {plain['evaluators'][0][1]:.3f} s; launches NMS {plain['nms']}, BEV scan {plain['scan']} for "
        f"{batches} batch(es)")
    buckets = {f"{h}x{w}": c for (h, w), c in tta.stats["buckets"].items()}
    log(f"phase27 TTA test ({type(tta).__name__}, MIN_SIZES {NUSC_TTA_SIZES} with flip, cut from the experiment's "
        f"{list(experiment_cfg(NUSC).TEST.AUG.MIN_SIZES)}) on {card}: {tta_pass['seconds']:.2f} s, "
        f"{n / tta_pass['seconds']:.2f} images/s; buckets (instances) {buckets}; host seconds by part "
        f"{ {k: round(v, 3) for k, v in tta.stats['seconds'].items()} }; evaluator process "
        f"{tta_pass['evaluators'][0][0]:.3f} s, evaluate {tta_pass['evaluators'][0][1]:.3f} s; BEV NMS over "
        f"{len(bev_merges)} merges; launches NMS {tta_pass['nms']}, BEV scan {tta_pass['scan']}")
    if plain["nms"] != batches or plain["scan"] != 2 * batches:
        raise AssertionError(f"phase27: the plain test launched NMS {plain['nms']}, scan {plain['scan']} for "
                             f"{batches} batches")
    if type(tta).__name__ != "RecordedTTA" or not tta.do_bev_nms or len(bev_merges) != n:
        raise AssertionError(f"phase27: the TTA test did not run NuscenesDD3DWithTTA with the BEV NMS over every "
                             f"image's merge ({len(bev_merges)} of {n})")
    if tta_pass["nms"] or tta_pass["scan"] or "aggregate" not in tta.stats["seconds"]:
        raise AssertionError("phase27: the TTA variants ran an NMS kernel, or the host aggregation did not run")
    log(f"phase27 ok ({time.time() - t0:.2f} s)")
    return {"greedy_nms": plain["nms"], "greedy_nms_scan": plain["scan"]}


def phase28_nusc_train(card, children):
    """The training CLI, `+experiments=dd3d_nusc_dla34` on the fixture, under
    torch.distributed.run: NUSC_TRAIN_STEPS steps of NUSC_TRAIN_BATCH at the
    NUSC_TRAIN_SIZE resize bucket, TPU.PALLAS_STEM_DW on, the final test
    without TTA (phase 27 runs it). Checks: finite losses every step,
    loss_attr and loss_speed finite and non-zero at the logged step, the dW
    kernel launched twice a step. The child is nusc_children's, and its step
    times were taken beside the other children. Returns (dW launches, ms a
    step)."""
    t0 = time.time()
    res = cli_result("--cli-rank", children["train"])
    with open(os.path.join(res["output_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_row = [r for r in rows if "total_loss" in r][-1]
    ms = float(np.median(res["step_ms"][1:])) if len(res["step_ms"]) > 1 else float("nan")
    shapes = sorted({tuple(x) for x in res["shapes"]})
    log(f"phase28 training CLI on {card}: {len(res['shapes'])} steps of shapes {shapes} "
        f"in {res['seconds']:.1f} s (process start, model and final test included); losses "
        + ", ".join(f"{v:.3f}" for v in res["losses"]) + f"; at step {train_row['step']}: loss_attr "
        f"{train_row.get('loss_attr', np.nan):.4f}, loss_speed {train_row.get('loss_speed', np.nan):.4f}; median "
        f"{ms:.2f} ms a step (after the first, the wait for the batch included); peak {res['peak_gib']:.2f} GiB; dW "
        f"kernel launches {res['dw_launches']}")
    if len(res["losses"]) != NUSC_TRAIN_STEPS or not np.all(np.isfinite(res["losses"])):
        raise AssertionError("phase28: a step is missing or a loss is not finite")
    for key in ("loss_attr", "loss_speed"):
        if not (np.isfinite(train_row.get(key, np.nan)) and train_row[key] > 0):
            raise AssertionError(f"phase28: {key} is missing, not finite or zero")
    if res["dw_launches"] != 2 * NUSC_TRAIN_STEPS:
        raise AssertionError(f"phase28: the dW kernel launched {res['dw_launches']} times in {NUSC_TRAIN_STEPS} steps")
    log(f"phase28 ok ({time.time() - t0:.2f} s)")
    return res["dw_launches"], ms


REGNETY = "dd3d_kitti_regnety_006_bifpn"
NMS_LARGE = ((2, 4096), (8, 5000), (1, 10000))  # (B, N) past the one-warp scan; 5000: PRE_NMS_TOPK 1000 x 5 levels
SCAN_LARGE = (2, 4096)
REGNETY_TRAIN_STEPS = 4
DENSE_DEPTH_STEPS = 4
DENSE_DEPTH_DENSITY = 0.05  # share of pixels with a GT depth, near a projected 64-beam scan's at 384x1280


def nms_large_bounds(boxes, valid, thr):
    """Bounds (ms, bound_by) of the NMS past N = 2048 on these inputs: the
    function (nms_bound: the greedy walk's IoU tests; boxes and valid read,
    keep written), and each of its two kernels on its own inputs and
    outputs (csrc/nms.cu): the mask kernel tests every pair of the upper
    triangle, reads the boxes and writes the scratch words on or right of
    the diagonal; the block scan reads those words and valid, writes keep
    (bytes; its ORs are no f32 work)."""
    b, n = valid.shape
    words = -(-n // 64)
    scratch = 8 * b * sum(min(64, n - 64 * r) * (words - r) for r in range(words))
    pairs = 0  # nms_bound's count, walked an image at a time in numpy (f32, as the kernel rounds)
    for bx, alive in zip(boxes.cpu().numpy(), valid.cpu().numpy().astype(bool)):
        x1, y1, x2, y2 = bx.T
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        for k in range(n - 1):
            if not alive[k]:
                continue
            j = np.flatnonzero(alive[k + 1:]) + k + 1
            pairs += len(j)
            inter = (np.maximum(np.minimum(x2[k], x2[j]) - np.maximum(x1[k], x1[j]), 0)
                     * np.maximum(np.minimum(y2[k], y2[j]) - np.maximum(y1[k], y1[j]), 0))
            alive[j[inter / np.maximum(area[k] + area[j] - inter, np.float32(1e-9)) > thr]] = False
    fn = bound_ms(boxes.numel() * 4 + valid.numel() * 2, NMS_OPS_PER_PAIR * pairs + NMS_OPS_PER_BOX * b * n, "f32")
    ops = NMS_OPS_PER_PAIR * b * n * (n - 1) // 2 + NMS_OPS_PER_BOX * b * n
    return {"function": fn, "mask": bound_ms(boxes.numel() * 4 + scratch, ops, "f32"),
            "block scan": bound_ms(scratch + 2 * valid.numel(), 0, "f32")}


def phase29_nms_large(device, images, intrinsics, card):
    """The NMS kernels past N = 2048 (the block scan): keep masks equal to
    the plain versions at each (B, N) of NMS_LARGE on random boxes, and the
    BEV scan at SCAN_LARGE, with device times against the plain ones; then
    dd3d_kitti_dla34 bf16 serving at batch 8 with the reference's 1000
    candidates a level and no cap (TPU.PRE_NMS_CANDIDATES_PER_LEVEL=1000,
    TPU.NMS_CANDIDATES=0: every level's candidates, N > 2048, reach the
    kernel), its detections identical through the kernel and the plain
    suppression. Returns (max
    error, the kernel's launches on that serving path, {(B, N): (kernel ms,
    plain ms)})."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms import greedy_suppress
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain, greedy_nms_scan

    t0 = time.time()
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    gen = torch.Generator().manual_seed(SEED + 29)
    times, max_err = {}, 0
    for b, n in NMS_LARGE:
        bx, vd = random_sorted_boxes(gen, b, n, device)
        bx = bx * (n / 512) ** 0.5  # the same density of boxes a pixel as at N = 512
        keep_k, keep_p = greedy_nms(bx, vd, 0.5), greedy_nms_plain(bx, vd, 0.5)
        torch.cuda.synchronize()
        err = int((keep_k.int() - keep_p.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"phase29 (B, N) = ({b}, {n}): kernel and plain keep masks differ")
        by_kernel = device_ms_by_kernel(lambda: greedy_nms(bx, vd, 0.5), 10, prof)
        k_ms = sum(by_kernel.values())
        p_ms = cuda_ms(lambda: greedy_nms_plain(bx, vd, 0.5), 2)
        times[b, n] = (k_ms, p_ms)
        bounds = nms_large_bounds(bx, vd, 0.5)
        log(f"phase29 nms (B, N) = ({b}, {n}): kept {int(keep_k.sum())}/{int(vd.sum())}, equal to the plain version "
            f"(tolerance 0); kernels' device time {k_ms:.4f} ms a call (profiler: " + ", ".join(
                f"{k.split('::')[-1].split('(')[0]} {v:.4f}" for k, v in sorted(by_kernel.items()))
            + f"), plain {p_ms:.3f} ms (CUDA events); bounds: " + ", ".join(
                f"{k} {v[0]:.5f} ms by {v[1]}" for k, v in bounds.items()))
    iou, valid = card_tests().scan_case(np.random.RandomState(SEED + 29), *SCAN_LARGE)
    it, vt = torch.from_numpy(iou).to(device), torch.from_numpy(valid).to(device)
    keep_k, keep_p = greedy_nms_scan(it, vt, 0.3), greedy_suppress(it, vt, 0.3)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError(f"phase29 BEV scan {SCAN_LARGE}: kernel and plain keep masks differ")
    k_ms = device_ms(lambda: greedy_nms_scan(it, vt, 0.3), 10, prof)
    p_ms = cuda_ms(lambda: greedy_suppress(it, vt, 0.3), 2)
    times[("scan",) + SCAN_LARGE] = (k_ms, p_ms)
    log(f"phase29 BEV scan (B, N) = {SCAN_LARGE}: kept {int(keep_k.sum())}/{int(vt.sum())}, equal to the plain "
        f"version; pack + block scan {k_ms:.4f} ms device time, plain {p_ms:.3f} ms")

    cfg = experiment_cfg("dd3d_kitti_dla34", **{"TPU.PRE_NMS_CANDIDATES_PER_LEVEL": 1000, "TPU.NMS_CANDIDATES": 0})
    model = build(cfg, device)
    sizes = []

    def recording(boxes, valid, thr):
        sizes.append(tuple(valid.shape))
        return greedy_nms(boxes, valid, thr)

    infer = get_inference_fn(model, cfg, suppress=recording)
    greedy_nms.launches = 0
    dets = [infer(im, intrinsics) for im in images]
    torch.cuda.synchronize()
    launches = greedy_nms.launches
    det_p = get_inference_fn(model, cfg, suppress=greedy_nms_plain)(images[0], intrinsics)
    for k in det_p:
        if not torch.equal(dets[0][k], det_p[k]):
            raise AssertionError(f"phase29 serving at N = {sizes[0][1]}: {k} differs between the kernel and the "
                                 "plain path")
    if sizes[0][1] <= 2048 or launches != N_BATCHES:
        raise AssertionError(f"phase29: NMS inputs {sizes}, {launches} launches for {N_BATCHES} batches")
    med, _, _ = serving_ms(get_inference_fn(model, cfg), images, intrinsics)
    log(f"phase29 dd3d_kitti_dla34 bf16 serving with 1000 candidates a level and no cap: NMS at (B, N) = "
        f"{sizes[0]}, {launches} kernel launches for {N_BATCHES} batches, detections identical to the plain "
        f"suppression's ({int(det_p['valid'].sum())} kept); {med:.3f} ms a batch = {BATCH / med * 1e3:.2f} "
        f"images/s on {card}")
    del model
    log(f"phase29 ok ({time.time() - t0:.2f} s)")
    return max_err, launches, times


def regnety_cfg(**overrides):
    return experiment_cfg(REGNETY, **overrides)


def regnety_int8_cfg():
    """bench.py's serving settings on this model: static int8, QUANT_MIN_CH
    32, QUANT_UNFOLDED (the BiFPN depthwise convs and the predictors too)."""
    return regnety_cfg(**{"TPU.QUANT_INT8": True, "TPU.QUANT_MIN_CH": 32, "TPU.QUANT_UNFOLDED": True})


def phase30_regnety_serve(device, images, intrinsics, card):
    """bf16 serving of dd3d_kitti_regnety_006_bifpn (RegNetY-006 + BiFPN 160
    x 3, P3-P7) at batch 8, 384x1280, weights from randomize_state: phase
    2's checks, phase 3's, phase 4's (fp32 on the card against the CPU at
    batch 1, 384x1280), images/s, the profiler's device time and launches a
    batch, busy share and peak memory. Returns (model, cfg, NMS launches,
    images/s)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    t0 = time.time()
    cfg = regnety_cfg()
    model = build(cfg, device)
    log(f"phase30 {REGNETY}: {cfg.FE.BACKBONE.NAME}, BiFPN {model.backbone.out_channels} x "
        f"{len(model.backbone.cells)}, levels {model.strides}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters")
    torch.cuda.reset_peak_memory_stats()
    launches, _ = phase2_serve(cfg, model, images, intrinsics, phase="phase30")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase3_plain_path(cfg, model, images, intrinsics, phase="phase30")
    phase4_fp32(regnety_cfg(), device, shape=(1, HEIGHT, WIDTH), phase="phase30")
    infer = get_inference_fn(model, cfg)
    med, p25, p75 = serving_ms(infer, images, intrinsics)
    dev_ms, n_kernels = serving_profile(infer, images, intrinsics)
    log(f"phase30 timing on {card}: bf16 serving, batch {BATCH} {HEIGHT}x{WIDTH}: median {med:.3f} ms/batch "
        f"(p25 {p25:.3f}, p75 {p75:.3f}) = {BATCH / med * 1e3:.2f} images/s; profiler: {dev_ms:.3f} ms of device "
        f"time and {n_kernels:.0f} kernel launches a batch (device busy {dev_ms / med:.3f} of the host's ms); "
        f"peak memory {peak:.2f} GiB; NMS kernel launches {launches}")
    log(f"phase30 ok ({time.time() - t0:.2f} s)")
    return model, cfg, launches, BATCH / med * 1e3


def grouped_conv_bound(xq, wq, stride, pad, groups, out_bytes=2):
    """Least time of one grouped int8 conv: x and w read, the output written
    (bf16), scale and bias read, against 2*M*O*k*k*C/g int8 operations."""
    b, h, w, c = xq.shape
    o, kh, kw, cg = wq.shape
    m = b * ((h + 2 * pad - kh) // stride + 1) * ((w + 2 * pad - kw) // stride + 1)
    return bound_ms(xq.numel() + wq.numel() + m * o * out_bytes + 8 * o, 2 * m * o * kh * kw * cg, "int8")


def cudnn_bf16_grouped(xq, wq, stride, pad, groups):
    """cuDNN's bf16 grouped conv of the same codes, channels_last: the
    library yardstick; the port never calls it for int8."""
    xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return lambda: torch.nn.functional.conv2d(xb, wb, stride=stride, padding=pad, groups=groups)


def phase31_grouped_sites(grouped, device, card, phase="phase31", below_cudnn=True, per="forward"):
    """The grouped int8 conv at every distinct grouped shape of `grouped`
    ({(B, H, W, C, O, k, stride, groups): count a forward}; the regnety
    forward at batch 8, 384x1280 in phase 31): on every route the shape
    admits (its own, and `direct`), accumulators, bf16 and f32 epilogues bit
    for bit against the plain version; device time of its own route, of
    `direct` and of cuDNN's bf16 grouped conv of the same codes in turns
    (direct, own, cuDNN, cuDNN, own, direct, twice; medians), beside the
    bound; its own route no slower than `direct`, and the sum on the own
    routes below cuDNN's. Sums are count x ms (`per`: what a count counts).
    Returns ({route: max error}, (own route, plain, bound, bound_by, cudnn)
    ms at the largest shape, sums {"own", "direct", "cudnn", "bound", "n"}).
    With `below_cudnn` False the sum against cuDNN's is logged, not gated (a
    route that loses stays, timed)."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.int8_conv import (dequant_plain, grouped_routes, int8_conv_grouped,
                                              int8_conv_grouped_acc_plain)

    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    gen = torch.Generator().manual_seed(SEED + 31)
    errors, largest = {}, None
    sums = dict.fromkeys(("own", "direct", "cudnn", "bound"), 0.0)
    sums["n"] = 0
    for key, count in sorted(grouped.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3]):
        b, h, w, c, o, k, stride, g = key
        pad = (k - 1) // 2
        xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8).to(device)
        wq = torch.randint(-127, 128, (o, k, k, c // g), generator=gen, dtype=torch.int8).to(device)
        scale = (torch.rand(o, generator=gen) * 1e-3 + 1e-5).to(device)
        bias = torch.randn(o, generator=gen).to(device)
        acc = int8_conv_grouped_acc_plain(xq, wq, stride, pad, g)
        want = {"acc": acc.float(), **{str(dt): dequant_plain(acc, scale, bias, dt)
                                       for dt in (torch.bfloat16, torch.float32)}}
        routes = grouped_routes(c, o, k, k, stride, g)
        for route in routes:
            got = {"acc": int8_conv_grouped(xq, wq, torch.ones(o, device=device), None, stride, pad,
                                            torch.float32, g, route=route),
                   **{str(dt): int8_conv_grouped(xq, wq, scale, bias, stride, pad, dt, g, route=route)
                      for dt in (torch.bfloat16, torch.float32)}}
            torch.cuda.synchronize()
            for name, value in got.items():
                errors[route] = max(errors.get(route, 0.0), float((value.float() - want[name].float()).abs().max()))
                if not torch.equal(value, want[name]):
                    raise AssertionError(f"{phase} grouped {key} {route} {name}: kernel and plain differ")
        own = routes[0]
        calls = {r: (lambda r=r: int8_conv_grouped(xq, wq, scale, bias, stride, pad, torch.bfloat16, g, route=r))
                 for r in ("direct", own)}
        calls["cudnn"] = cudnn_bf16_grouped(xq, wq, stride, pad, g)
        turns = {name: [] for name in calls}
        for name in ("direct", own, "cudnn", "cudnn", own, "direct") * 2:
            turns[name].append(device_ms(calls[name], 10, prof))
        # medians: a profiler window now and then reads short (part of its
        # kernels missing) or a few times long
        own_ms, direct_ms, c_ms = (float(np.median(turns[name])) for name in (own, "direct", "cudnn"))
        bnd, by = grouped_conv_bound(xq, wq, stride, pad, g)
        log(f"{phase} grouped int8 conv (B,H,W,C)=({b},{h},{w},{c}) O={o} k={k} s={stride} g={g} x{count}/{per}: "
            f"routes {routes} each equal to the plain version (accumulators, bf16 and f32; tolerance 0); device "
            f"time in turns (direct, {own}, cuDNN, cuDNN, {own}, direct, twice): "
            + "; ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in turns[name]) + " ms" for name in turns)
            + f"; medians {own} {own_ms:.4f}, direct {direct_ms:.4f}, cuDNN bf16 grouped {c_ms:.4f} ms; bound "
            f"{bnd:.5f} ms by {by} ({bnd / own_ms:.2f} of it on {own}, {bnd / direct_ms:.2f} on direct)")
        if own_ms > direct_ms:
            raise AssertionError(f"{phase} grouped {key}: the {own} route ({own_ms:.4f} ms) is slower than direct "
                                 f"({direct_ms:.4f} ms)")
        for name, ms in (("own", own_ms), ("direct", direct_ms), ("cudnn", c_ms), ("bound", bnd)):
            sums[name] += count * ms
        sums["n"] += count
        if largest is None:
            p_ms = cuda_ms(lambda: dequant_plain(int8_conv_grouped_acc_plain(xq, wq, stride, pad, g), scale, bias,
                                                 torch.bfloat16), 3)
            largest = (own_ms, p_ms, bnd, by, c_ms)
            log(f"{phase} grouped int8 conv at its largest shape {key}: plain version {p_ms:.3f} ms (CUDA events)")
    log(f"{phase} timing on {card}: grouped int8 convs a {per} ({sums['n']} convs), device time: own routes "
        f"{sums['own']:.4f} ms, direct {sums['direct']:.4f} ms, cuDNN bf16 grouped {sums['cudnn']:.4f} ms, bound "
        f"{sums['bound']:.4f} ms ({sums['bound'] / sums['own']:.2f} of it; count x ms summed)")
    if below_cudnn and sums["own"] >= sums["cudnn"]:
        raise AssertionError(f"{phase}: the grouped convs of a forward take {sums['own']:.4f} ms on their routes, "
                             f"not below cuDNN bf16 grouped's {sums['cudnn']:.4f} ms")
    return errors, largest, sums


@contextlib.contextmanager
def grouped_on_direct():
    """Every grouped int8 conv on `direct` (the first, general kernel) for the
    span of the block: a wrapper with route="direct" stands in for the
    module's int8_conv_grouped. It counts its launches on its own name (the
    wrapper counts on the module's), so the stand-in carries counters too;
    yields it."""
    from dd3d_tpu_torch.ops import int8_conv as int8_ops

    dispatch = int8_ops.int8_conv_grouped

    def on_direct(*args, **kwargs):
        return dispatch(*args, **kwargs, route="direct")

    on_direct.launches = 0
    on_direct.launches_by_route = dict.fromkeys(int8_ops.GROUPED_ROUTES, 0)
    int8_ops.int8_conv_grouped = on_direct
    try:
        yield on_direct
    finally:
        int8_ops.int8_conv_grouped = dispatch


def grouped_routes_forward_ms(infer, images, intrinsics):
    """Device ms a batch of the int8 path `infer` (serving_profile) with
    every grouped conv on `direct` (`grouped_on_direct`) and on its own
    route, in turns (direct, own, own, direct): ({"direct": [...], "own":
    [...]}, launches by route in the direct turns)."""
    from dd3d_tpu_torch.ops.int8_conv import GROUPED_ROUTES

    times = {"direct": [], "own": []}
    forced = dict.fromkeys(GROUPED_ROUTES, 0)
    for arm in ("direct", "own", "own", "direct"):
        if arm == "own":
            times[arm].append(serving_profile(infer, images, intrinsics)[0])
            continue
        with grouped_on_direct() as on_direct:
            times[arm].append(serving_profile(infer, images, intrinsics)[0])
        for route, n in on_direct.launches_by_route.items():
            forced[route] += n
    return times, forced


def forced_not_direct(forced):
    """The routes other than `direct` that launched in the direct turns."""
    return {route: n for route, n in forced.items() if route != "direct" and n}


def regnety_predict_children(tmp):
    """Phase 31's children on a 375x1200 frame: `predict` in bf16 beside
    `calibrate_int8` and then `predict` in static int8 from its scales."""
    from concurrent.futures import ThreadPoolExecutor

    from dd3d_tpu_torch.data.imageio import write_png

    frames = os.path.join(tmp, "regnety_frames")
    os.makedirs(frames, exist_ok=True)
    write_png(os.path.join(frames, "000000.png"),
              np.random.RandomState(SEED + 31).randint(0, 256, (375, 1200, 3)).astype(np.uint8))
    common = ["--experiment", REGNETY, "--images", frames, "--intrinsics", KITTI_INTRINSICS]
    scales = os.path.join(tmp, "regnety_scales.json")
    with ThreadPoolExecutor(1) as pool:
        bf16 = pool.submit(run_child, ["-m", "dd3d_tpu_torch.predict", *common, "--out",
                                       os.path.join(tmp, "regnety_bf16.json")])
        out = {"calibrate_int8": run_child(["-m", "dd3d_tpu_torch.calibrate_int8", *common, "--out", scales,
                                            "TPU.QUANT_MIN_CH=0", "TPU.QUANT_UNFOLDED=True"])}
        if out["calibrate_int8"][0].returncode == 0:
            out["predict int8"] = run_child([
                "-m", "dd3d_tpu_torch.predict", *common, "--out", os.path.join(tmp, "regnety_int8.json"),
                "TPU.QUANT_INT8=True", "TPU.QUANT_MIN_CH=32", "TPU.QUANT_UNFOLDED=True",
                f"TPU.QUANT_SCALES_PATH={scales}"])
        out["predict bf16"] = bf16.result()
    return out


def phase31_regnety_int8(model, bf16_cfg, images, intrinsics, device, tmp, card, children):
    """Static int8 of dd3d_kitti_regnety_006_bifpn in bench.py's settings:
    phase 7 at every distinct ungrouped int8 conv site, the grouped kernel at
    every grouped site (phase31_grouped_sites), phase 8's path checks with
    scales from 2 batches (launches of all four kernels, no scale miss,
    kernel and plain int8 detections identical, drift against bf16), int8
    against bf16 in turns, the int8 batch's device time with the grouped
    convs on `direct` and on their own routes in turns; then the CLIs
    (regnety_predict_children) on a 375x1200 frame: `predict` in bf16,
    `calibrate_int8`, and `predict` in static int8 from its scales.
    Returns (launches by kernel, max error of the ungrouped sites, of the
    grouped ones, the grouped kernel's numbers at its largest shape, images/s
    {int8, bf16}, the grouped sums)."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    t0 = time.time()
    grouped = {}
    int8_conv_sites(model, images[0], unfolded=True, grouped=grouped)
    conv_err, sites, _, _ = phase7_int8_conv(model, images[0], unfolded=True, phase="phase31")
    log(f"phase31 {len(grouped)} grouped int8 conv shapes, {sum(grouped.values())} grouped convs a forward")
    g_errs, g_largest, g_sums = phase31_grouped_sites(grouped, device, card)
    cfg8, launches = phase8_int8_path(bf16_cfg, model, images, intrinsics, sites, base_cfg=regnety_int8_cfg(),
                                      phase="phase31", grouped=grouped)
    want = {"direct": 0, "depthwise": 24 * N_BATCHES, "mma": 15 * N_BATCHES, "narrow": 0}
    if launches["int8_conv_grouped_by_route"] != want:
        raise AssertionError(f"phase31: grouped launches by route {launches['int8_conv_grouped_by_route']}, "
                             f"expected {want} (24 BiFPN dw and 15 Y-block b convs a forward)")
    paths = {"int8": get_inference_fn(model, cfg8), "bf16": get_inference_fn(model, bf16_cfg)}
    runs = {"int8": [], "bf16": []}
    for name in ("int8", "bf16", "bf16", "int8"):
        runs[name].append(serving_ms(paths[name], images, intrinsics)[0])
    ips = {name: BATCH / (np.mean(ms) / 1e3) for name, ms in runs.items()}
    log(f"phase31 timing on {card}: serving in turns (int8, bf16, bf16, int8), median ms/batch int8 "
        f"{runs['int8'][0]:.3f} / {runs['int8'][1]:.3f}, bf16 {runs['bf16'][0]:.3f} / {runs['bf16'][1]:.3f}: "
        f"static int8 {ips['int8']:.2f} images/s, bf16 {ips['bf16']:.2f} images/s")
    fwd, forced = grouped_routes_forward_ms(paths["int8"], images, intrinsics)
    if forced["direct"] == 0 or forced_not_direct(forced):
        raise AssertionError(f"phase31: the direct turns' grouped launches by route {forced}")
    log(f"phase31 timing on {card}: static int8 serving, device time a batch (profiler) in turns (direct, own, own, "
        f"direct): every grouped conv on direct {fwd['direct'][0]:.3f} / {fwd['direct'][1]:.3f} ms (launches by "
        f"route {forced}), on its own route {fwd['own'][0]:.3f} / {fwd['own'][1]:.3f} ms")
    launches["fusion"] = fusion_ab(model, cfg8, images, intrinsics, "phase31", card)

    scales = os.path.join(tmp, "regnety_scales.json")
    outs = {name: os.path.join(tmp, f"regnety_{name}.json") for name in ("bf16", "int8")}
    for name in ("predict bf16", "calibrate_int8", "predict int8"):
        proc, seconds = children[name]
        if proc.returncode != 0:
            raise AssertionError(f"phase31 {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        if "no calibrated scale" in proc.stderr:
            raise AssertionError(f"phase31 {name}: a static scale missed: {proc.stderr[-1000:]}")
        log(f"phase31 {name} CLI ({seconds:.1f} s): " + proc.stdout.strip().splitlines()[-1][:200])
    with open(scales) as f:
        keys = json.load(f)
    for key in ("backbone/bottom_up/s1_b0/b/conv", "backbone/cell2/p7_out_conv/dw"):
        if key not in keys:
            raise AssertionError(f"phase31: calibrate_int8 wrote no scale for the grouped conv {key}")
    for name, path in outs.items():
        with open(path) as f:
            records = json.load(f)
        boxes = np.asarray(records[0]["boxes2d"]).reshape(-1, 4)
        if len(records) != 1 or not len(boxes) or boxes[:, 2].max() > 1200 or boxes[:, 3].max() > 375:
            raise AssertionError(f"phase31: predict {name}'s detections are missing or outside the 1200x375 frame")
        log(f"phase31 predict {name}: {len(boxes)} detections inside the 1200x375 frame")
    log(f"phase31 ok ({time.time() - t0:.2f} s): calibrate_int8 wrote {len(keys)} convs")
    return launches, conv_err, max(g_errs.values()), g_largest, ips, g_sums


def timed_train_steps(cfg, model, batches, steps, device, phase):
    """`steps` steps of make_train_step after one, each synchronised and
    timed, then one profiler window over the batches: (metrics by step,
    (median, p25, p75) ms, peak GiB, device ms a step, busy share,
    launches a step)."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.training.train_loop import create_train_state
    from dd3d_tpu_torch.training.train_step import make_train_step

    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, model, device)
    step = make_train_step(cfg, state.model, state.optimizer)
    metrics = [step(batches[0])]
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        t = time.perf_counter()
        metrics.append(step(batches[i % len(batches)]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, m in enumerate(metrics):
        if m["loss_finite"] != 1.0 or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{phase} step {i + 1}: a metric is not finite: {m}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = device_rows(prof)
    busy = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
               for e in kernels) / 1e3
    return (metrics, np.percentile(times, [50, 25, 75]), peak, busy / len(batches), busy / wall_ms,
            sum(e.count for e in kernels) / len(batches))


def regnety_train_children(tmp):
    """Phase 32's children on a fixture of its own: the training CLI for 2
    steps, then EVAL_ONLY from its checkpoint."""
    from dd3d_tpu_torch.overfit_smoke import make_fixture

    root = make_fixture(os.path.join(tmp, "regnety_fixture"), n_images=8)
    data = [f"DATASET_ROOT={root}", "DATASETS.TEST.NAME=kitti_3d_train", "SOLVER.IMS_PER_BATCH=8"]
    out = {"train": cli_child("--cli-rank", [
        f"+experiments={REGNETY}", *data, f"OUTPUT_ROOT={os.path.join(tmp, 'rg_out')}", "SOLVER.MAX_ITER=2",
        "SOLVER.CHECKPOINT_PERIOD=2", "TEST.EVAL_PERIOD=0", "VIS.DATALOADER_ENABLED=False", "TEST.AUG.ENABLED=False",
        THREAD_LOADER])}
    trained = cli_output(out["train"])
    if trained is not None:
        out["eval"] = cli_child("--eval-only", [
            f"+experiments={REGNETY}", "EVAL_ONLY=True", f"MODEL.CKPT={os.path.join(trained['output_dir'], 'ckpt')}",
            *data[:2], "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0", "TEST.AUG.ENABLED=False",
            f"OUTPUT_ROOT={os.path.join(tmp, 'rg_eval')}"])
    return out


def phase32_regnety_train(device, card, children):
    """The bf16 train step of dd3d_kitti_regnety_006_bifpn at batch 8,
    384x1280, on seeded synthetic batches (He-initialized convs, seeded norm
    statistics): finite losses, ms a step, peak memory, the profiler's
    launches and busy share; then the training CLI for 2 steps on the port's
    8-frame fixture and EVAL_ONLY from its checkpoint (the KITTI-3D and
    COCO-2D evaluators; regnety_train_children). Returns (ms a step, peak
    GiB, NMS launches of EVAL_ONLY)."""
    from dd3d_tpu_torch.training.train_loop import to_device

    t0 = time.time()
    cfg = regnety_cfg()
    batches = [to_device(b, device) for b in train_batches(cfg, 3, BATCH, HEIGHT, WIDTH, SEED + 32)]
    metrics, (med, p25, p75), peak, dev_ms, busy, n_kernels = timed_train_steps(
        cfg, build_train_model(cfg, "cpu"), batches, REGNETY_TRAIN_STEPS, device, "phase32")
    log("phase32 total loss by step: " + ", ".join(f"{m['total_loss']:.3f}" for m in metrics))
    log(f"phase32 timing on {card}: {REGNETY} bf16 train step, batch {BATCH} {HEIGHT}x{WIDTH}: median {med:.2f} ms "
        f"(p25 {p25:.2f}, p75 {p75:.2f}) over {REGNETY_TRAIN_STEPS} steps = {BATCH / med * 1e3:.2f} images/s; peak memory {peak:.2f} GiB; "
        f"profiler: {dev_ms:.2f} ms of device time a step, busy share {busy:.3f}, {n_kernels:.0f} kernel launches "
        f"a step")
    del batches
    torch.cuda.empty_cache()

    res = cli_result("--cli-rank", children["train"])
    log(f"phase32 train CLI: {len(res['shapes'])} steps of batch 8 in {res['seconds']:.1f} s, losses "
        + ", ".join(f"{v:.3f}" for v in res["losses"]))
    if len(res["losses"]) != 2 or not np.all(np.isfinite(res["losses"])):
        raise AssertionError("phase32: the training CLI did not take 2 finite steps")
    ev = cli_result("--eval-only", children["eval"])
    with open(os.path.join(ev["output_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    coco = [k for k in rows[-1] if "bbox/AP" in k]
    log(f"phase32 EVAL_ONLY CLI ({ev['seconds']:.1f} s): NMS kernel launches {ev['nms_launches']}, {CAR_AP3D} = "
        f"{rows[-1].get(CAR_AP3D, float('nan')):.4f}, COCO-2D keys {coco[:3]}")
    if ev["nms_launches"] < 1 or not np.isfinite(rows[-1].get(CAR_AP3D, np.nan)) or not coco:
        raise AssertionError("phase32: EVAL_ONLY did not launch the NMS kernel or log both evaluators' results")
    log(f"phase32 ok ({time.time() - t0:.2f} s)")
    return med, peak, ev["nms_launches"]


def dense_depth_cfg():
    """dd3d_kitti_dla34 as DD3DDenseDepth (depth pretraining), with the
    stem's weight gradient on the kernel."""
    return experiment_cfg("dd3d_kitti_dla34", **{"MODEL.META_ARCHITECTURE": "DD3DDenseDepth",
                                                   "MODEL.DEPTH_ON": True, "TPU.PALLAS_STEM_DW": True})


def phase33_dense_depth_train(device, card):
    """DD3DDenseDepth's bf16 train step at batch 8, 384x1280, through
    make_train_step on seeded synthetic batches with sparse GT depth
    (DENSE_DEPTH_DENSITY of the pixels): finite losses, parameters moving,
    the dW kernel's launches, ms a step, peak memory, busy share. Returns
    (ms a step, peak GiB, dW launches)."""
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.training.synthetic import synthetic_batch
    from dd3d_tpu_torch.training.train_loop import to_device

    t0 = time.time()
    cfg = dense_depth_cfg()
    model = build_train_model(cfg, "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(SEED + 33)
    batches = [to_device(synthetic_batch(rng, BATCH, HEIGHT, WIDTH, max_gt=cfg.TPU.MAX_GT_PER_IMAGE,
                                         depth_density=DENSE_DEPTH_DENSITY), device) for _ in range(3)]
    conv_dw.conv_dw_s1_same.launches = 0
    metrics, (med, p25, p75), peak, dev_ms, busy, n_kernels = timed_train_steps(cfg, model, batches,
                                                                                DENSE_DEPTH_STEPS, device, "phase33")
    torch.cuda.synchronize()
    dw = conv_dw.conv_dw_s1_same.launches
    steps = 1 + DENSE_DEPTH_STEPS + len(batches)
    moved = sum(not torch.equal(p.detach().cpu(), before[n]) for n, p in model.named_parameters())
    log("phase33 losses of the last step: " + ", ".join(f"{k} {v:.4f}" for k, v in metrics[-1].items()
                                                         if k.startswith("loss_dense")))
    log(f"phase33 timing on {card}: DD3DDenseDepth (DLA-34) bf16 train step, batch {BATCH} {HEIGHT}x{WIDTH}, "
        f"{DENSE_DEPTH_DENSITY} of the pixels with GT depth: median {med:.2f} ms (p25 {p25:.2f}, p75 {p75:.2f}) "
        f"over {DENSE_DEPTH_STEPS} steps = "
        f"{BATCH / med * 1e3:.2f} images/s; peak memory {peak:.2f} GiB; profiler: {dev_ms:.2f} ms of device time a "
        f"step, busy share {busy:.3f}, {n_kernels:.0f} kernel launches a step; dW kernel launches {dw} in {steps} "
        f"steps; {moved} of {len(before)} parameters moved")
    if dw != 2 * steps:
        raise AssertionError(f"phase33: {dw} dW kernel launches in {steps} steps, not 2 a step")
    if moved < 0.9 * len(before):
        raise AssertionError(f"phase33: only {moved} of {len(before)} parameters moved")
    del batches, model
    torch.cuda.empty_cache()
    log(f"phase33 ok ({time.time() - t0:.2f} s)")
    return med, peak, dw


def phase34_quantize_exhaustive(device):
    """The quantize kernel (csrc/quantize.cu, division-free by
    csrc/quantize.cuh) against its plain version on every non-NaN bf16
    value at 20 scales, as bf16 and as f32 input, and on ragged and
    unaligned bf16 and f32 tensors: tests/test_torch_cuda.py's checks, loaded
    by path. Returns the max |kernel - plain| (0: they assert equality)."""
    tests = card_tests()
    t0 = time.time()
    tests.test_quantize_kernel_equals_plain_on_every_bf16_value(device)
    for dtype in (torch.bfloat16, torch.float32):
        tests.test_quantize_kernel_ragged_and_unaligned(device, dtype)
    torch.cuda.synchronize()
    log(f"phase34 ok ({time.time() - t0:.2f} s): the quantize kernel equals its plain version on all "
        f"{65536 - 254} non-NaN bf16 values at {len(tests.QUANT_SCALES)} scales (bf16 and f32 input), and on ragged "
        "and unaligned tensors (tolerance 0: codes must be equal)")
    return 0


def phase35_s8_epilogue(device, card):
    """The int8 conv's s8 epilogue (ReLU and the next quantize) against
    `int8_conv_requant_plain`, bit for bit, at every head-tower shape of
    DLA-34, V2-99 and RegNetY + BiFPN and a ragged M (tests/test_torch_cuda.py,
    loaded by path); then at the P3 tower conv (8, 48, 160, 256) -> 256, the
    device time (profiler) of the conv with the s8 epilogue, with the bf16
    one, and of the unfused link (bf16 conv, ReLU, quantize kernel), in
    turns, beside the plain version, cuDNN's bf16 conv and the bound. The s8
    arm runs at two scales of the next conv: a calibrated one (a bf16 amax
    of the output / 127, as calibration gives) and the round 0.05, at which
    bf16 values x 20 land on exact .5 ties often (each takes the FMA step of
    csrc/quantize.cuh). Returns (max error, (ms, plain_ms, bound_ms,
    bound_by, library_ms)) at the calibrated scale."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_requant_plain
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    tests = card_tests()
    t0 = time.time()
    for shape in tests.TOWER_SHAPES:
        tests.test_int8_conv_s8_epilogue_matches_plain(device, *shape)
    torch.cuda.synchronize()
    log(f"phase35 s8 epilogue equal to int8_conv_requant_plain at {len(tests.TOWER_SHAPES)} tower shapes, bf16 and "
        f"f32 epilogues (tolerance 0) ({time.time() - t0:.2f} s)")
    ms, plain_ms, bnd, by, library_ms, _ = s8_epilogue_timing(QUANT_SHAPE, device, card, "phase35")
    log(f"phase35 ok ({time.time() - t0:.2f} s)")
    return 0, (ms, plain_ms, bnd, by, library_ms)


def s8_epilogue_timing(shape, device, card, phase):
    """At the tower conv `shape` (B, H, W, C) -> C, 3x3: the device time
    (profiler, medians of three turns) of the int8 conv with the s8 epilogue
    (at a calibrated and at the round 0.05 scale), with the bf16 one, and of
    the unfused link (bf16 conv, ReLU, quantize kernel), beside the plain
    version (CUDA events), cuDNN's bf16 conv and the bound; the s8 and bf16
    outputs equal to the plain version's. Returns (s8 ms, plain ms, bound
    ms, bound_by, cuDNN ms, bf16 ms)."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, int8_conv_requant_plain
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    gen = torch.Generator().manual_seed(SEED + 35)
    b, h, w, c = shape
    xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8).to(device)
    wq = torch.randint(-127, 128, (c, 3, 3, c), generator=gen, dtype=torch.int8).to(device)
    scale = (torch.rand(c, generator=gen) * 1e-4 + 1e-5).to(device)
    bias = torch.randn(c, generator=gen).to(device)
    amax = int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16).amax()  # a bf16 value, as calibration records
    xs_next = (amax.float() / 127).reshape(1)
    xs_round = torch.tensor([0.05], device=device)
    for got, want in ((int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16, requant=xs_next),
                       int8_conv_requant_plain(xq, wq, scale, bias, 1, 1, torch.bfloat16, xs_next)),
                      (int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16),
                       int8_conv_plain(xq, wq, scale, bias, 1, 1, torch.bfloat16))):
        if not torch.equal(got, want):
            raise AssertionError(f"{phase}: the int8 conv at {shape} differs from its plain version")
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    arms = {
        "s8": lambda: int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16, requant=xs_next),
        "s8 at 0.05": lambda: int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16, requant=xs_round),
        "bf16": lambda: int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16),
        "unfused": lambda: quantize_int8(torch.relu(int8_conv(xq, wq, scale, bias, 1, 1, torch.bfloat16)), xs_next),
    }
    t = {k: [] for k in arms}
    for name in (*arms, *reversed(arms), *arms):
        t[name].append(device_ms(arms[name], 10, prof))
    run_plain = lambda: int8_conv_requant_plain(xq, wq, scale, bias, 1, 1, torch.bfloat16, xs_next)  # noqa: E731
    run_plain()
    plain_ms = cuda_ms(run_plain, 1 if b * h * w > 10 ** 6 else 3)
    library_ms = device_ms(cudnn_bf16_conv(xq, wq, 1, 1), 10, prof)
    bnd, by = int8_conv_bound(xq, wq, 1, 1, out_bytes=1)
    # medians of three turns: a profiler window now and then reads short or
    # long
    ms = {k: float(np.median(v)) for k, v in t.items()}
    turns = {k: " / ".join(f"{x:.4f}" for x in v) for k, v in t.items()}
    log(f"{phase} timing on {card}: tower conv {tuple(shape)} -> {c}, 3x3, device time in turns (medians): s8 "
        f"epilogue {turns['s8']} ms ({ms['s8']:.4f}) at the calibrated scale {float(xs_next):.6g} "
        f"({100 * (ms['s8'] / ms['bf16'] - 1):+.1f} % against the bf16 epilogue), {turns['s8 at 0.05']} ms "
        f"({ms['s8 at 0.05']:.4f}) at 0.05 ({100 * (ms['s8 at 0.05'] / ms['bf16'] - 1):+.1f} %), bf16 epilogue "
        f"{turns['bf16']} ms ({ms['bf16']:.4f}), the unfused link (bf16 conv, ReLU, quantize) {turns['unfused']} ms "
        f"({ms['unfused']:.4f}); plain {plain_ms:.3f} ms, cuDNN bf16 conv {library_ms:.4f} ms, bound {bnd:.4f} ms "
        f"by {by} ({bnd / ms['s8']:.2f} of the s8 conv)")
    del xq, wq
    torch.cuda.empty_cache()
    return ms["s8"], plain_ms, bnd, by, library_ms, ms["bf16"]


# --- int8 nuScenes, the DLA family and the head options (phases 36-41) -----------

NUSC_INT8 = {"TPU.QUANT_INT8": True, "TPU.QUANT_MIN_CH": 32, "TPU.QUANT_UNFOLDED": True}  # bench.py's
NUSC_V99_INT8 = {"TPU.QUANT_INT8": True, "TPU.QUANT_MIN_CH": 32}  # scripts/bench_v99.py's: predictors stay bf16
NUSC_TTA_INT8_SAMPLES = 2  # phase 38's fixture: 12 frames, every TEST.AUG size of the experiment
DLA_NEW_VARIANTS = ("DLA-46-C", "DLA-X-46-C", "DLA-X-60-C", "DLA-60", "DLA-X-60", "DLA-102", "DLA-X-102",
                    "DLA-X-102-64", "DLA-169")
DLA_X = "DLA-X-60"
DLA_X_TRAIN_STEPS = 4
HEAD_OPTIONS = {"DD3D.FCOS2D._VERSION": "v1", "DD3D.FCOS3D.PER_LEVEL_PREDICTORS": True,
                "DD3D.FCOS3D.CLASS_AGNOSTIC_BOX3D": True}


def min_ch_report(sites, min_ch, phase):
    """The int8 sites of a calibration-regime forward (QUANT_MIN_CH 0) that
    the serving gate `min_ch` keeps in bf16, logged: {(C, O, k, stride):
    count a forward}."""
    kept = {}
    for key, n in sites.items():
        if key[3] < min_ch:
            kept[key[3:7]] = kept.get(key[3:7], 0) + n
    total = sum(sites.values())
    log(f"{phase} QUANT_MIN_CH {min_ch}: {total - sum(kept.values())} of {total} eligible convs a forward quantize; "
        f"kept in bf16 (C, O, k, stride): count {kept}")
    return kept


def head_drift(out_b, out_8):
    """Mean |int8 - bf16| of the attribute logits and the speeds over every
    level, against the bf16 outputs' mean magnitude."""
    out = {}
    for key in ("attr_logits", "speed"):
        diff = torch.cat([(a.float() - b.float()).abs().reshape(-1) for a, b in zip(out_8[key], out_b[key])])
        mag = torch.cat([b.float().abs().reshape(-1) for b in out_b[key]])
        out[key] = (float(diff.mean()), float(mag.mean()))
    return out


def nusc_int8(name, overrides, device, card, phase, n_batches, time_it=True):
    """Static int8 serving of a nuScenes experiment at full width and depth,
    batch 12 (two samples of 6 cameras), 896x1664, randomize_state weights,
    with the sample aggregation: every int8 conv shape of the path against
    its plain version (phase 7), the convs QUANT_MIN_CH keeps in bf16,
    calibration on 2 batches, `n_batches` batches served with the launches
    of the quantize, the int8 conv by output kind, the NMS and the BEV scan
    counted (the cls tower's last link stays unfused: its output is read by
    the cls predictor and the attribute/speed group), no scale miss; the
    kernels' and the plain versions' detections identical; int8 against bf16
    within tests/test_int8_infer.py's drift bounds, with the attribute
    logits' and speeds' drift beside them; with `time_it`, ms a batch and
    device time a batch of int8 and bf16 in turns. Returns a dict."""
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.layers import quant_scope
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_grouped
    from dd3d_tpu_torch.ops.nms import greedy_suppress
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain, greedy_nms_scan
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    t0 = time.time()
    cfg_b = experiment_cfg(name)
    model = build(cfg_b, device)
    images, ks, pq, pt = nusc_batches(cfg_b, device)
    images = images[:max(2, n_batches)]
    conv_err, sites, cases, _ = phase7_int8_conv(model, images[0], unfolded=bool(overrides.get("TPU.QUANT_UNFOLDED")),
                                                 phase=phase)
    p3 = [case for (b, h, w, c, o, k, stride), _, case in cases
          if (c, o, k, stride, h) == (256, 256, 3, 1, images[0].shape[1] // 8)]
    del cases
    min_ch = overrides["TPU.QUANT_MIN_CH"]
    kept = min_ch_report(sites, min_ch, phase)  # neither backbone has a grouped conv
    cfg8 = prepare_static_scales(experiment_cfg(name, **overrides), model, images[:2], tag=phase)
    torch.cuda.synchronize()
    log(f"{phase} {name}: calibrated on 2 batches of {NUSC_BATCH} {tuple(images[0].shape[1:3])} "
        f"({time.time() - t0:.1f} s so far)")
    infer = get_inference_fn(model, cfg8, group_size=6)
    per_forward = sum(n for key, n in sites.items() if key[3] >= min_ch)
    levels = len(model.strides)
    fused = fused_links_per_forward(model.base, cfg8) - (levels if overrides.get("TPU.QUANT_UNFOLDED") else 0)
    zero_launches()
    dets = [infer(im, ks, pq, pt) for im in images[:n_batches]]  # the main path
    torch.cuda.synchronize()
    launches = {"greedy_nms": greedy_nms.launches, "greedy_nms_scan": greedy_nms_scan.launches,
                "quantize_int8": quantize_int8.launches, "int8_conv": int8_conv.launches,
                "int8_conv_by_out": dict(int8_conv.launches_by_out), "int8_conv_grouped": int8_conv_grouped.launches}
    want = {"greedy_nms": n_batches, "greedy_nms_scan": 2 * n_batches,
            "quantize_int8": (per_forward - fused) * n_batches, "int8_conv": per_forward * n_batches,
            "int8_conv_by_out": {"f32": 0, "bf16": (per_forward - fused) * n_batches, "s8": fused * n_batches},
            "int8_conv_grouped": 0}
    log(f"{phase} served {n_batches} batch(es) in static int8 with the aggregation: launches {launches}; "
        f"{per_forward} int8 convs and {fused} fused tower links a forward")
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    if infer.quant.misses:
        raise AssertionError(f"{phase}: static scales missed {infer.quant.misses[:5]}")
    d = cfg8.DD3D.FCOS2D.INFERENCE.POST_NMS_TOPK
    for i, det in enumerate(dets):
        for k, v in det.items():
            if tuple(v.shape[:2]) != (NUSC_BATCH, d) or (v.is_floating_point() and not torch.isfinite(v).all()):
                raise AssertionError(f"{phase} batch {i}: {k} has shape {tuple(v.shape)} or is not finite")
        if not bool(det["valid"].view(2, -1).any(dim=1).all()):
            raise AssertionError(f"{phase} batch {i}: a sample has no detection")
    plain = get_inference_fn(model, cfg8, group_size=6, suppress=greedy_nms_plain, scan=greedy_suppress,
                             int8_plain=True)(images[0], ks, pq, pt)
    torch.cuda.synchronize()
    for k in dets[0]:
        if not torch.equal(dets[0][k], plain[k]):
            raise AssertionError(f"{phase}: {k} differs between the int8 kernel path and the plain path")
    log(f"{phase} int8 kernel-path and plain-path detections identical ({int(plain['valid'].sum())} kept, "
        f"attributes and speeds included)")
    det_b = get_inference_fn(model, cfg_b, group_size=6)(images[0], ks, pq, pt)
    sa, sb = top_scores(det_b), top_scores(dets[0])
    drift = float((sa - sb).abs().mean())
    mass = abs(float(sa.sum()) - float(sb.sum())) / max(float(sa.sum()), 1e-6)
    with torch.inference_mode():
        out_b = model(images[0])
        with quant_scope(infer.quant):
            out_8 = model(images[0])
    heads = head_drift(out_b, out_8)
    log(f"{phase} int8 vs bf16, top-50 scores of batch 0: mean |diff| {drift:.4f} (limit 0.05), relative score "
        f"mass {mass:.4f} (limit 0.25); head outputs mean |int8 - bf16| (mean |bf16|): attr_logits "
        f"{heads['attr_logits'][0]:.4f} ({heads['attr_logits'][1]:.4f}), speed {heads['speed'][0]:.4f} "
        f"({heads['speed'][1]:.4f})")
    if drift >= 0.05 or mass >= 0.25:
        raise AssertionError(f"{phase}: int8 detections drift too far from bf16")
    out = {"launches": launches, "conv_err": conv_err, "kept_bf16": kept, "drift": (drift, mass), "heads": heads,
           "p3": p3[0] if p3 else None}
    if time_it:
        paths = {"int8": infer, "bf16": get_inference_fn(model, cfg_b, group_size=6)}
        ms, dev = {"int8": [], "bf16": []}, {"int8": [], "bf16": []}
        for arm in ("int8", "bf16", "bf16", "int8"):
            run = lambda im, _k, f=paths[arm]: f(im, ks, pq, pt)  # noqa: E731
            ms[arm].append(serving_ms(run, images, None)[0])
            dev[arm].append(serving_profile(run, images, None)[0])
        for arm in ms:
            log(f"{phase} timing on {card}: {name} {arm} serving with the aggregation, batch {NUSC_BATCH} "
                f"{tuple(images[0].shape[1:3])}: median {ms[arm][0]:.3f} / {ms[arm][1]:.3f} ms a batch = "
                f"{NUSC_BATCH / np.mean(ms[arm]) * 1e3:.2f} images/s; device time a batch (profiler) "
                f"{dev[arm][0]:.3f} / {dev[arm][1]:.3f} ms (in turns int8, bf16, bf16, int8)")
        out.update(ms=ms, device_ms=dev)
    del model
    torch.cuda.empty_cache()
    log(f"{phase} ok ({time.time() - t0:.2f} s)")
    return out


def phase36_nusc_int8(device, card):
    """dd3d_nusc_dla34 in bench.py's int8 settings (`nusc_int8`, 3 batches,
    timed), the int8 conv with the s8 and the bf16 epilogue at its P3
    tower conv (12, 112, 208, 256); then dd3d_nusc_v99 in
    scripts/bench_v99.py's settings once (1 batch, untimed)."""
    dla = nusc_int8(NUSC, NUSC_INT8, device, card, "phase36", NUSC_N_BATCHES)
    p3 = dla.pop("p3")
    dla["p3_s8"] = s8_epilogue_timing(tuple(p3[0].shape), device, card, "phase36")
    del p3
    v99 = nusc_int8(NUSC_V99, NUSC_V99_INT8, device, card, "phase36 v99", 1, time_it=False)
    v99.pop("p3")
    return dla, v99


def phase37_nusc_int8_eval(tmp, device, card):
    """EVAL_ONLY of dd3d_nusc_dla34 in static int8 (bench.py's overrides, no
    scales file: the plain test quantizes with dynamic scales, the TTA test
    calibrates each canvas bucket on its first batch) through `train.main`
    on a 2-sample fixture (12 PNGs at 900x1600) with the experiment's own
    TEST.AUG (five sizes 640-1152 with flip: the 1152 bucket's canvas is
    1152x2048): finite NDS and mAP in both rows, the five buckets calibrated
    and no static scale missed, launches of the quantize and the int8 conv
    in both passes; the int8 conv at the 1152 bucket's P3 tower conv against
    its plain version and timed, and `batch_chunks`' runs there for this
    chunk and for the experiment's 96-frame chunk. Returns launches."""
    import dd3d_tpu_torch.train as train_mod
    from dd3d_tpu_torch.models import tta as tta_mod
    from dd3d_tpu_torch.ops.int8_conv import batch_chunks, int8_conv
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_scan
    from dd3d_tpu_torch.ops.quantize import quantize_int8
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture

    t0 = time.time()
    root = make_nusc_fixture(os.path.join(tmp, "nusc_int8_fixture"), n_samples=NUSC_TTA_INT8_SAMPLES,
                             height=NUSC_HW[0], width=NUSC_HW[1])
    passes, ttas = [], []
    real_test, real_tta = train_mod.do_test, tta_mod.NuscenesDD3DWithTTA

    def measured_test(cfg, model, output_dir, step=None, use_tta=False):
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        out = real_test(cfg, model, output_dir, step=step, use_tta=use_tta)
        torch.cuda.synchronize()
        passes.append({"tta": use_tta, "seconds": time.perf_counter() - t, "greedy_nms": greedy_nms.launches,
                       "greedy_nms_scan": greedy_nms_scan.launches, "quantize_int8": quantize_int8.launches,
                       "int8_conv": int8_conv.launches, "int8_conv_s8": int8_conv.launches_by_out["s8"]})
        return out

    class RecordedTTA(real_tta):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            ttas.append(self)

    train_mod.do_test, tta_mod.NuscenesDD3DWithTTA = measured_test, RecordedTTA
    torch.cuda.reset_peak_memory_stats()
    try:
        out_dir = train_mod.main([f"+experiments={NUSC}", "EVAL_ONLY=True", f"DATASET_ROOT={root}",
                                  f"DATASETS.TEST.NAME={NUSC_FIXTURE}", "DD3D.FCOS2D.INFERENCE.PRE_NMS_THRESH=0.0",
                                  *(f"{k}={v}" for k, v in NUSC_INT8.items()),
                                  f"OUTPUT_ROOT={os.path.join(tmp, 'nusc_int8_eval')}"])
    finally:
        train_mod.do_test, tta_mod.NuscenesDD3DWithTTA = real_test, real_tta
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for label, row, key in (("plain", rows[0], NUSC_NDS), ("tta", rows[1], "tta/" + NUSC_NDS)):
        mAP = row.get(key.replace("NDS", "mAP"), np.nan)
        log(f"phase37 int8 {label} test: NDS {row.get(key, np.nan):.4f}, mAP {mAP:.4f}")
        if not (np.isfinite(row.get(key, np.nan)) and np.isfinite(mAP)):
            raise AssertionError(f"phase37: the int8 {label} test's NDS or mAP is not finite")
    plain, tta_pass = passes
    tta = ttas[-1]
    n = 6 * NUSC_TTA_INT8_SAMPLES
    buckets = {f"{h}x{w}": c for (h, w), c in tta.stats["buckets"].items()}
    sizes = list(experiment_cfg(NUSC).TEST.AUG.MIN_SIZES)
    log(f"phase37 int8 plain test on {card}: {plain['seconds']:.2f} s for {n} frames; launches {plain}")
    log(f"phase37 int8 TTA test ({type(tta).__name__}, MIN_SIZES {sizes} with flip) on {card}: "
        f"{tta_pass['seconds']:.2f} s, {n / tta_pass['seconds']:.2f} images/s; buckets (instances) {buckets}; "
        f"calibrated {tta.stats['calibrated']}; host seconds by part "
        f"{ {k: round(v, 3) for k, v in tta.stats['seconds'].items()} }; peak memory {peak:.2f} GiB; launches "
        f"{tta_pass}")
    if not (plain["int8_conv"] and plain["quantize_int8"] and plain["greedy_nms"] and plain["greedy_nms_scan"]):
        raise AssertionError(f"phase37: the int8 plain test's launches {plain}")
    if len(tta.stats["calibrated"]) != len(sizes) or tta.quant.misses or not tta_pass["int8_conv"]:
        raise AssertionError(f"phase37: calibrated {tta.stats['calibrated']}, misses {tta.quant.misses[:3]}, "
                             f"launches {tta_pass}")
    largest = max(tta.stats["buckets"], key=lambda hw: hw[0] * hw[1])
    count = tta.stats["buckets"][largest]
    if largest != (1152, 2048):
        raise AssertionError(f"phase37: the largest bucket is {largest}, not 1152x2048")
    per_image = largest[0] * largest[1] * 16  # level0's 16-channel activation, the largest int8 conv input
    log(f"phase37 batch_chunks at the {largest[0]}x{largest[1]} bucket's level0 conv: {count} instances -> runs "
        f"{batch_chunks(count, per_image)}; the experiment's chunk of {experiment_cfg(NUSC).TEST.IMS_PER_BATCH} "
        f"frames (x2 with flip) -> {len(batch_chunks(2 * experiment_cfg(NUSC).TEST.IMS_PER_BATCH, per_image))} runs")
    shape = (count, largest[0] // 8, largest[1] // 8, 256)
    p3 = s8_epilogue_timing(shape, device, card, "phase37")
    log(f"phase37 ok ({time.time() - t0:.2f} s)")
    return {"plain": plain, "tta": tta_pass, "p3_1152": p3, "p3_shape": shape}


def phase38_dla_family(device, images, intrinsics, card):
    """Each DLA variant beyond DLA-34 (Bottleneck, BottleneckX with
    cardinality 32 and 64, residual roots) under dd3d_kitti_dla34's heads
    (FPN 256, P6P7), randomize_state weights: one bf16 batch of 8 at
    384x1280 through get_inference_fn, shapes and finite values, the NMS
    kernel launched once; ms of the batch after one warm-up, parameters."""
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    t0 = time.time()
    nms = 0
    for name in DLA_NEW_VARIANTS:
        t = time.time()
        cfg = experiment_cfg("dd3d_kitti_dla34", **{"FE.BACKBONE.NAME": name})
        model = build(cfg, device)
        infer = get_inference_fn(model, cfg)
        infer(images[1], intrinsics)
        torch.cuda.synchronize()
        greedy_nms.launches = 0
        t1 = time.perf_counter()
        det = infer(images[0], intrinsics)  # the main path
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        nms += greedy_nms.launches
        for k, v in det.items():
            if v.shape[:2] != (BATCH, 100) or (v.is_floating_point() and not torch.isfinite(v).all()):
                raise AssertionError(f"phase38 {name}: {k} has shape {tuple(v.shape)} or is not finite")
        if greedy_nms.launches != 1 or not bool(det["valid"].any()):
            raise AssertionError(f"phase38 {name}: NMS launches {greedy_nms.launches}, kept {int(det['valid'].sum())}")
        log(f"phase38 {name} bf16 on {card}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, "
            f"batch {BATCH} {HEIGHT}x{WIDTH} in {ms:.2f} ms (one batch after a warm-up), "
            f"{int(det['valid'].sum())} detections kept, all finite ({time.time() - t:.1f} s)")
        del model, infer
        torch.cuda.empty_cache()
    log(f"phase38 ok ({time.time() - t0:.2f} s): {len(DLA_NEW_VARIANTS)} variants")
    return nms


# The narrow route's other DLA-X shapes at batch 8, 384x1280, (B, H, W, C,
# O, k, stride, groups): DLA-X-60-C's C/g = 2 at level 2 and DLA-X-102-64's
# stride-2 convs with 64 groups (C/g 4 and 8); one call each
DLA_X_NARROW_EXTRA = {(8, 192, 640, 64, 64, 3, 2, 32): 1, (8, 96, 320, 64, 64, 3, 1, 32): 1,
                      (8, 192, 640, 256, 256, 3, 2, 64): 1, (8, 96, 320, 512, 512, 3, 2, 64): 1}


def phase39_dla_x_int8(device, images, intrinsics, card):
    """DLA-X-60 (BottleneckX, cardinality 32: C/g = 4, 8, 16 and 32 at levels
    2-5) under dd3d_kitti_dla34's heads in bench.py's static int8: phase 7
    at every ungrouped int8 site; the grouped kernel at every grouped site
    on every route the shape admits, bit for bit, timed on its own route, on
    `direct` and cuDNN's bf16 grouped conv in turns beside the bound
    (`phase31_grouped_sites`, cuDNN not gated: a route that loses stays),
    then the same at DLA_X_NARROW_EXTRA's shapes; phase 8's path checks
    (launches by route: `narrow` and `mma` both non-zero); the int8 batch's
    device time with every grouped conv on `direct` and on its own route in
    turns, and its detections identical on both. Returns (launches, max
    error of the ungrouped sites, {route: max error} of the grouped ones,
    the grouped sums, `narrow`'s (own, plain, bound, bound_by, cudnn) ms at
    the largest C/g 4 shape, device ms a batch {"direct", "own"})."""
    t0 = time.time()
    cfg = experiment_cfg("dd3d_kitti_dla34", **{"FE.BACKBONE.NAME": DLA_X})
    model = build(cfg, device)
    grouped = {}
    int8_conv_sites(model, images[0], unfolded=True, grouped=grouped)
    conv_err, sites, _, _ = phase7_int8_conv(model, images[0], unfolded=True, phase="phase39")
    log(f"phase39 {DLA_X}: {len(grouped)} grouped int8 conv shapes, {sum(grouped.values())} grouped convs a forward")
    g_errs, narrow_t, g_sums = phase31_grouped_sites(grouped, device, card, phase="phase39", below_cudnn=False)
    log("phase39 DLA-X-60-C's C/g 2 and DLA-X-102-64's 64-group shapes, one call each:")
    extra_errs, _, _ = phase31_grouped_sites(DLA_X_NARROW_EXTRA, device, card, phase="phase39", below_cudnn=False,
                                             per="call")
    for route, err in extra_errs.items():
        g_errs[route] = max(g_errs.get(route, 0.0), err)
    base = experiment_cfg("dd3d_kitti_dla34", **{"FE.BACKBONE.NAME": DLA_X, **NUSC_INT8})
    cfg8, launches = phase8_int8_path(cfg, model, images, intrinsics, sites, base_cfg=base, phase="phase39",
                                      grouped=grouped)
    by_route = launches["int8_conv_grouped_by_route"]
    if not (by_route["narrow"] and by_route["mma"]):
        raise AssertionError(f"phase39: grouped launches by route {by_route}: narrow and mma must both run")
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    infer = get_inference_fn(model, cfg8)
    det = infer(images[0], intrinsics)
    with grouped_on_direct() as on_direct:
        det_direct = infer(images[0], intrinsics)
    torch.cuda.synchronize()
    for k in det:
        if not torch.equal(det[k], det_direct[k]):
            raise AssertionError(f"phase39: {k} differs between the grouped convs' own routes and direct")
    if on_direct.launches_by_route["direct"] == 0 or forced_not_direct(on_direct.launches_by_route):
        raise AssertionError(f"phase39: the direct batch's grouped launches by route {on_direct.launches_by_route}")
    log(f"phase39 static int8 detections identical with the grouped convs on their own routes and all on direct "
        f"({int(det['valid'].sum())} kept; direct launches {on_direct.launches_by_route['direct']})")
    fwd, forced = grouped_routes_forward_ms(infer, images, intrinsics)
    if forced["direct"] == 0 or forced_not_direct(forced):
        raise AssertionError(f"phase39: the direct turns' grouped launches by route {forced}")
    batch_ms = {arm: float(np.median(ms)) for arm, ms in fwd.items()}
    log(f"phase39 timing on {card}: {DLA_X} static int8 serving, device time a batch (profiler) in turns (direct, "
        f"own, own, direct): every grouped conv on direct {fwd['direct'][0]:.3f} / {fwd['direct'][1]:.3f} ms "
        f"(launches by route {forced}), on its own route (narrow, mma) {fwd['own'][0]:.3f} / {fwd['own'][1]:.3f} "
        f"ms; medians {batch_ms['direct']:.3f} / {batch_ms['own']:.3f} ms")
    del model, infer
    torch.cuda.empty_cache()
    log(f"phase39 ok ({time.time() - t0:.2f} s)")
    return launches, conv_err, g_errs, g_sums, narrow_t, batch_ms


def phase40_dla_x_train(device, card):
    """DLA-X-60's bf16 train step at batch 8, 384x1280, TPU.PALLAS_STEM_DW,
    on seeded synthetic batches (He-initialized convs, seeded norm
    statistics): finite losses, the dW kernel twice a step, ms a step, peak
    memory, busy share. Returns (ms a step, dW launches)."""
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.training.train_loop import to_device

    t0 = time.time()
    cfg = experiment_cfg("dd3d_kitti_dla34", **{"FE.BACKBONE.NAME": DLA_X, "TPU.PALLAS_STEM_DW": True})
    batches = [to_device(b, device) for b in train_batches(cfg, 2, BATCH, HEIGHT, WIDTH, SEED + 40)]
    conv_dw.conv_dw_s1_same.launches = 0
    metrics, (med, p25, p75), peak, dev_ms, busy, n_kernels = timed_train_steps(
        cfg, build_train_model(cfg, "cpu"), batches, DLA_X_TRAIN_STEPS, device, "phase40")
    torch.cuda.synchronize()
    dw = conv_dw.conv_dw_s1_same.launches
    steps = 1 + DLA_X_TRAIN_STEPS + len(batches)
    log("phase40 total loss by step: " + ", ".join(f"{m['total_loss']:.3f}" for m in metrics))
    log(f"phase40 timing on {card}: {DLA_X} bf16 train step, batch {BATCH} {HEIGHT}x{WIDTH}: median {med:.2f} ms "
        f"(p25 {p25:.2f}, p75 {p75:.2f}) over {DLA_X_TRAIN_STEPS} steps; peak memory {peak:.2f} GiB; profiler: "
        f"{dev_ms:.2f} ms of device time a step, busy share {busy:.3f}, {n_kernels:.0f} kernel launches a step; dW "
        f"kernel launches {dw} in {steps} steps")
    if dw != 2 * steps:
        raise AssertionError(f"phase40: {dw} dW kernel launches in {steps} steps, not 2 a step")
    del batches
    torch.cuda.empty_cache()
    log(f"phase40 ok ({time.time() - t0:.2f} s)")
    return med, dw


def phase41_head_options(device, images, intrinsics, card):
    """DLA-34 with FCOS2D _VERSION v1 (tower biases), PER_LEVEL_PREDICTORS
    and CLASS_AGNOSTIC_BOX3D together: bf16 serving (phase 2's checks, then
    the plain suppression's detections identical), then bench.py's static
    int8 (phase 8's path checks: each level's predictor group keyed by its
    own first sibling, the v1 bias in the s8 links), then the tower links
    fused and unfused in turns (identical detections). Returns launches."""
    t0 = time.time()
    cfg = experiment_cfg("dd3d_kitti_dla34", **HEAD_OPTIONS)
    model = build(cfg, device)
    if not (model.fcos2d_head.cls_tower[0].bias is not None and len(model.fcos3d_head.box3d_quat) == 5
            and model.fcos3d_head.box3d_conf[0].out_channels == 1):
        raise AssertionError("phase41: the head options did not build")
    bf16_nms, _ = phase2_serve(cfg, model, images, intrinsics, phase="phase41")
    phase3_plain_path(cfg, model, images, intrinsics, phase="phase41")
    sites = int8_conv_sites(model, images[0], unfolded=True)
    cfg8, launches = phase8_int8_path(cfg, model, images, intrinsics, sites,
                                      base_cfg=experiment_cfg("dd3d_kitti_dla34", **HEAD_OPTIONS, **NUSC_INT8),
                                      phase="phase41")
    launches["fusion"] = fusion_ab(model, cfg8, images, intrinsics, "phase41", card)
    launches["greedy_nms"] += bf16_nms
    del model
    torch.cuda.empty_cache()
    log(f"phase41 ok ({time.time() - t0:.2f} s)")
    return launches




# --- JPEG frames, TPU.REMAT and the new image kinds (phases 42-44) ------------

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
JPEG_FRAME = "frame_900x1600.jpg"  # a nuScenes camera's size, 4:2:0 at quality 90
JPEG_DECODE_REPS = 20
JPEG_LOADER_PASSES = 3  # of each format, in turns
REMAT_POLICIES = ("none", "full", "dots_saveable")
REMAT_TIMED_STEPS = 6


def jpeg_manifests(tmp):
    """Two JSON manifests of one nuScenes-style fixture (make_nusc_fixture's
    dicts: 2 samples of 6 cameras at 900x1600, poses, intrinsics):
    `nusc_jpg`, every frame a copy of the committed JPEG_FRAME (the card's
    machine cannot encode JPEGs), and `nusc_png`, the same pixels as the
    port decodes them, written as PNGs with write_png. Returns the root."""
    from dd3d_tpu_torch.data.imageio import decode_bgr, write_png
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture

    root = make_nusc_fixture(os.path.join(tmp, "jpeg_fixture"), n_samples=NUSC_BATCH // 6, height=NUSC_HW[0],
                             width=NUSC_HW[1])
    ds_dir = os.path.join(root, "json_datasets")
    with open(os.path.join(ds_dir, f"{NUSC_FIXTURE}.json")) as f:
        manifest = json.load(f)
    os.remove(os.path.join(ds_dir, f"{NUSC_FIXTURE}.json"))
    with open(os.path.join(JPEG_DIR, JPEG_FRAME), "rb") as f:
        jpeg = f.read()
    pixels = decode_bgr(jpeg, JPEG_FRAME)
    for kind in ("jpg", "png"):
        dicts = []
        for d in manifest["dicts"]:
            name = d["file_name"].replace(".png", f"_frame.{kind}")
            if kind == "jpg":
                with open(os.path.join(ds_dir, name), "wb") as f:
                    f.write(jpeg)
            else:
                write_png(os.path.join(ds_dir, name), pixels)
            dicts.append({**d, "file_name": name})
        with open(os.path.join(ds_dir, f"nusc_{kind}.json"), "w") as f:
            json.dump({**manifest, "name": f"nusc_{kind}", "dicts": dicts}, f)
    return root


def phase42_jpeg(tmp, device, card):
    """JPEG frames (the port's own decoder, csrc/imageio.cpp, on the host):
    every committed fixture of tests/data/jpeg decodes to the SHA-256 of
    the JAX package's libjpeg decode (digests.json); ms a frame of the
    900x1600 fixture on one thread; dd3d_nusc_dla34's test loader in
    images/s over 12 JPEG frames against the same pixels as PNGs, in turns;
    one bf16 batch of 12 (two samples of 6 cameras, 896x1664) served with
    the sample aggregation from the JPEG manifest and from the PNG one: the
    same canvases and identical detections. Returns the timings and the
    serving's launches."""
    import hashlib

    from dd3d_tpu_torch.data.augmentations import resize_shortest_edge_dims
    from dd3d_tpu_torch.data.build import TestDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.data.imageio import decode_bgr, read_image_bgr
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_scan

    t0 = time.time()
    with open(os.path.join(JPEG_DIR, "digests.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        img = read_image_bgr(os.path.join(JPEG_DIR, name))
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != want["shape"] or got != want["sha256"]:
            raise AssertionError(f"phase42: {name} decodes to {img.shape} {got}, not {want}")
    log(f"phase42 the {len(digests)} committed JPEG fixtures ({', '.join(sorted(digests))}) decode to the SHA-256 "
        "of the JAX package's libjpeg decode")
    with open(os.path.join(JPEG_DIR, JPEG_FRAME), "rb") as f:
        data = f.read()
    times = []
    for _ in range(JPEG_DECODE_REPS):
        t = time.perf_counter()
        decode_bgr(data)
        times.append((time.perf_counter() - t) * 1e3)
    frame_ms = float(np.median(times))
    log(f"phase42 timing on {card} (host): {JPEG_FRAME} ({len(data)} bytes) decodes in {frame_ms:.3f} ms a frame "
        f"on one thread (median of {JPEG_DECODE_REPS}; p25 {np.percentile(times, 25):.3f}, p75 "
        f"{np.percentile(times, 75):.3f}), {os.cpu_count()} host cores")

    root = jpeg_manifests(tmp)
    cfgs, ips, batches = {}, {"jpg": [], "png": []}, {}
    for kind in ("jpg", "png"):
        cfgs[kind] = experiment_cfg(NUSC, DATASET_ROOT=root, **{"DATASETS.TEST.NAME": f"nusc_{kind}",
                                                                 "TEST.IMS_PER_BATCH": NUSC_BATCH})
        register_datasets(cfgs[kind])
    for _ in range(JPEG_LOADER_PASSES):
        for kind in ("jpg", "png"):
            loader = TestDataLoader(cfgs[kind], group_size=6)
            t = time.perf_counter()
            got = list(loader)
            ips[kind].append(NUSC_BATCH / (time.perf_counter() - t))
            batches[kind] = got
    loader_ips = {k: float(np.median(v)) for k, v in ips.items()}
    log(f"phase42 timing on {card} (host): {NUSC}'s test loader, {NUSC_BATCH} frames of {NUSC_HW[0]}x{NUSC_HW[1]} "
        f"resized to MIN_SIZE_TEST {cfgs['jpg'].INPUT.RESIZE.MIN_SIZE_TEST} on "
        f"{cfgs['jpg'].DATALOADER.TEST.NUM_WORKERS} threads: JPEG {loader_ips['jpg']:.2f} images/s, PNG "
        f"{loader_ips['png']:.2f} images/s (medians of {JPEG_LOADER_PASSES} passes each, in turns: "
        f"{[round(v, 2) for v in ips['jpg']]} / {[round(v, 2) for v in ips['png']]})")
    (bj, _), = batches["jpg"]
    (bp, _), = batches["png"]
    r = cfgs["jpg"].INPUT.RESIZE
    canvas = tuple(-(-v // 128) * 128 for v in resize_shortest_edge_dims(*NUSC_HW, r.MIN_SIZE_TEST, r.MAX_SIZE_TEST))
    if bj["image"].shape[1:3] != canvas or bj["image"].tobytes() != bp["image"].tobytes():
        raise AssertionError(f"phase42: the JPEG batch {bj['image'].shape} is not the PNG batch's {canvas} canvases")

    cfg = cfgs["jpg"]
    model = build(cfg, device)
    infer = get_inference_fn(model, cfg, group_size=6)
    dets = {}
    for kind, b in (("png", bp), ("jpg", bj)):
        args = [torch.from_numpy(np.asarray(b[k])).to(device) for k in ("image", "intrinsics", "pose_quat",
                                                                          "pose_tvec")]
        if kind == "jpg":
            zero_launches()
        dets[kind] = infer(*args)
        torch.cuda.synchronize()
    launches = {"greedy_nms": greedy_nms.launches, "greedy_nms_scan": greedy_nms_scan.launches}
    for k, v in dets["jpg"].items():
        if not torch.equal(v, dets["png"][k]):
            raise AssertionError(f"phase42: {k} of the JPEG-served batch differs from the PNG-served one")
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"phase42: {k} is not finite")
    kept = int(dets["jpg"]["valid"].sum())
    log(f"phase42 {NUSC} bf16 batch of {NUSC_BATCH} served from the JPEG manifest and from the PNG one: identical "
        f"detections ({kept} kept), launches on the JPEG path {launches}")
    if kept == 0 or launches != {"greedy_nms": 1, "greedy_nms_scan": 2}:
        raise AssertionError(f"phase42: {kept} detections, launches {launches} (want 1 NMS and 2 scans)")
    del model
    torch.cuda.empty_cache()
    log(f"phase42 ok ({time.time() - t0:.2f} s)")
    return {"frame_ms": frame_ms, "loader_ips": loader_ips, "launches": launches}


PNG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "png")
# phase 44's frames, 375x1242 each, one of each kind past 8-bit RGB PNGs and
# Huffman JPEGs, in the order of the fixture's 8 frames
NEW_KIND_FRAMES = ((PNG_DIR, "frame_gama.png"), (PNG_DIR, "frame_palette_adam7.png"), (PNG_DIR, "frame_adam7.png"),
                   (PNG_DIR, "frame_16bit.png"), (JPEG_DIR, "frame_arith.jpg"), (JPEG_DIR, "frame_smoothed.jpg"),
                   (JPEG_DIR, "frame_cut_mid_segment.jpg"), (JPEG_DIR, "frame_cmyk.jpg"))
NEW_KIND_DECODE_REPS = 10


def new_kind_fixtures(tmp):
    """Two KITTI-format fixtures of 8 frames with the same labels and calib
    (make_fixture's): `kinds`, whose image_2 files hold the bytes of
    NEW_KIND_FRAMES (the reader tells formats apart by their magic bytes,
    not by the file's name), and `plain`, the same pixels as the port
    decodes them, written as 8-bit RGB PNGs with write_png."""
    from dd3d_tpu_torch.data.imageio import decode_bgr, write_png
    from dd3d_tpu_torch.overfit_smoke import make_fixture

    roots = {}
    for kind in ("kinds", "plain"):
        roots[kind] = make_fixture(os.path.join(tmp, f"new_kinds_{kind}"), n_images=len(NEW_KIND_FRAMES))
        image_dir = os.path.join(roots[kind], "KITTI3D", "training", "image_2")
        for i, (folder, name) in enumerate(NEW_KIND_FRAMES):
            with open(os.path.join(folder, name), "rb") as f:
                data = f.read()
            path = os.path.join(image_dir, f"{i:06d}.png")
            if kind == "kinds":
                with open(path, "wb") as f:
                    f.write(data)
            else:
                write_png(path, decode_bgr(data, name))
    return roots


def phase44_new_kinds(tmp, device, card, baseline_jpeg_ms):
    """The image kinds past 8-bit RGB PNGs and Huffman JPEGs (the host's own
    decoders in csrc/imageio.cpp and data/imageio.py; this machine has no
    cv2, libpng or libjpeg): every fixture of tests/data/png and
    tests/data/jpeg decodes to the SHA-256 of the JAX package's
    read_image_bgr; ms a frame on one host thread of each 375x1242 frame
    beside phase 42's baseline JPEG; dd3d_kitti_dla34's test loader serves
    one bf16 batch of 8 at 384x1280 from a fixture whose frames are the new
    kinds (gAMA, palette + Adam7, Adam7, 16-bit PNGs; arithmetic-coded,
    smoothed progressive, cut mid-segment and CMYK JPEGs) and from the same
    pixels as plain PNGs, in turns: the same canvases and identical
    detections, through the NMS kernel (launched) and its plain version
    (identical). Returns the timings and the serving's launches."""
    import hashlib

    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.data.imageio import decode_bgr, read_image_bgr
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain
    from dd3d_tpu_torch.overfit_smoke import overfit_cfg

    t0 = time.time()
    checked = []
    for folder in (PNG_DIR, JPEG_DIR):
        with open(os.path.join(folder, "digests.json")) as f:
            digests = json.load(f)
        for name, want in sorted(digests.items()):
            img = read_image_bgr(os.path.join(folder, name))
            got = hashlib.sha256(img.tobytes()).hexdigest()
            if list(img.shape) != want["shape"] or got != want["sha256"]:
                raise AssertionError(f"phase44: {name} decodes to {img.shape} {got}, not {want}")
            checked.append(name)
    log(f"phase44 the {len(checked)} PNG and JPEG fixtures decode to the SHA-256 of the JAX package's "
        f"read_image_bgr: {', '.join(checked)}")
    frame_ms = {}
    for folder, name in NEW_KIND_FRAMES:
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        times = []
        for _ in range(NEW_KIND_DECODE_REPS):
            t = time.perf_counter()
            decode_bgr(data, name)
            times.append((time.perf_counter() - t) * 1e3)
        frame_ms[name] = float(np.median(times))
    log(f"phase44 timing on {card} (host): ms a 375x1242 frame on one thread (median of {NEW_KIND_DECODE_REPS}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in frame_ms.items())
        + f"; phase 42's baseline 900x1600 JPEG {baseline_jpeg_ms:.3f}; {os.cpu_count()} host cores")

    roots = new_kind_fixtures(tmp)
    batches = {}
    for kind, root in roots.items():
        cfg = overfit_cfg(root, 1)
        cfg.TEST.IMS_PER_BATCH = len(NEW_KIND_FRAMES)
        register_datasets(cfg)
        loader = build_test_dataloader(cfg, dataset_name=cfg.DATASETS.TEST.NAME)
        batches[kind] = [b for b, _meta in loader]
    (bk,), (bp,) = batches["kinds"], batches["plain"]
    if bk["image"].shape[1:3] != (384, 1280) or bk["image"].tobytes() != bp["image"].tobytes():
        raise AssertionError(f"phase44: the new kinds' batch {tuple(bk['image'].shape)} is not the plain PNGs' "
                             "384x1280 canvases")
    model = build(cfg, device)
    dets = {}
    for turn, b, suppress in (("plain", bp, None), ("plain suppression", bk, greedy_nms_plain), ("kinds", bk, None)):
        args = [torch.from_numpy(np.asarray(b[k])).to(device) for k in ("image", "intrinsics")]
        if turn == "kinds":
            zero_launches()
        dets[turn] = get_inference_fn(model, cfg, suppress=suppress)(*args)
        torch.cuda.synchronize()
        if turn == "kinds":
            launches = {"greedy_nms": greedy_nms.launches}
    for other in ("plain", "plain suppression"):
        for k, v in dets["kinds"].items():
            if not torch.equal(v, dets[other][k]):
                raise AssertionError(f"phase44: {k} of the new kinds' batch differs from the {other} turn's")
    for k, v in dets["kinds"].items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"phase44: {k} is not finite")
    kept = int(dets["kinds"]["valid"].sum())
    log(f"phase44 dd3d_kitti_dla34 {cfg.TPU.COMPUTE_DTYPE} batch of {len(NEW_KIND_FRAMES)} at 384x1280 from the "
        f"new kinds and from plain PNGs of the same pixels: identical detections ({kept} kept), and identical with "
        f"the plain suppression; launches on the new kinds' path {launches}")
    if kept == 0 or launches != {"greedy_nms": 1}:
        raise AssertionError(f"phase44: {kept} detections, launches {launches} (want 1 NMS)")
    del model
    torch.cuda.empty_cache()
    log(f"phase44 ok ({time.time() - t0:.2f} s)")
    return {"frame_ms": frame_ms, "launches": launches}


def remat_run(cfg, policy, batches, device):
    """A fresh seeded dd3d_kitti_dla34 (TPU.PALLAS_STEM_DW) under TPU.REMAT =
    `policy`: its first step under torch.use_deterministic_algorithms(True),
    whose metrics, gradients, updated parameters and BN running stats are
    copied to the host, then REMAT_TIMED_STEPS steps timed with the peak
    memory over them, also less what was allocated before them (the model,
    its optimizer state, the batches and what earlier phases hold), then
    one profiled step (its device time, and its share of the median step);
    the dW kernel's launches over all of them."""
    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.training.train_loop import create_train_state
    from dd3d_tpu_torch.training.train_step import make_train_step

    cfg = cfg.clone()
    cfg.TPU.REMAT = policy
    state = create_train_state(cfg, build_train_model(cfg, "cpu"), device)
    step = make_train_step(cfg, state.model, state.optimizer)
    model = state.model
    torch.cuda.synchronize()
    conv_dw.conv_dw_s1_same.launches = 0
    torch.use_deterministic_algorithms(True)
    try:
        metrics = step(batches[0])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    first = {"metrics": {k: v.detach().cpu() for k, v in metrics.items()},
             "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
             "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
             "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()
                         if n.endswith(("running_mean", "running_var"))}}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for b in batches[1:]:
        t = time.perf_counter()
        m = step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if float(m["loss_finite"]) != 1.0:
            raise AssertionError(f"phase43 {policy}: a loss is not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # device records only: recording every host op too takes ~40 s a window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # one step: a window costs ~2 s a step here
        step(batches[1])
        torch.cuda.synchronize()
    kernels = device_rows(prof)
    device_ms = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                    for e in kernels) / 1e3
    dw = conv_dw.conv_dw_s1_same.launches
    del state, step, model
    torch.cuda.empty_cache()
    ms = float(np.median(times))
    return {"first": first, "ms": ms, "times": times, "peak_gib": peak, "step_gib": peak - base / 2 ** 30,
            "dw": dw, "device_ms": device_ms, "busy": device_ms / ms}


def differing(a, b):
    """The names of the tensors of `a` that differ from `b`'s in a bit or are
    missing there."""
    return [f"{kind} {name}" for kind in a for name, t in a[kind].items()
            if name not in b[kind] or not torch.equal(t, b[kind][name])]


def phase43_remat(vis_cli, device, card):
    """TPU.REMAT: dd3d_kitti_dla34's bf16 train step at batch 8, 384x1280,
    TPU.PALLAS_STEM_DW, under "none", "full" and "dots_saveable" and "none"
    again (the step itself deterministic), each from the same seeded
    weights: under deterministic algorithms the first step's losses,
    gradients, updated parameters and BN running stats equal "none"'s bit
    for bit; the dW kernel twice a step; ms a step and peak memory over
    REMAT_TIMED_STEPS more steps, and one profiled step's device time. Then
    the training CLI's steps under TPU.REMAT=full (phase 19's run, under
    torch.distributed.run: NCCL, world size 1): finite losses, the dW
    kernel twice a step. Returns the timings and the dW launches."""
    from dd3d_tpu_torch.training.train_loop import to_device

    t0 = time.time()
    cfg = train_cfg()
    batches = [to_device(b, device) for b in train_batches(cfg, 1 + REMAT_TIMED_STEPS, BATCH, HEIGHT, WIDTH,
                                                           SEED + 43)]
    runs = {}
    for policy in (*REMAT_POLICIES, "none"):
        runs["none again" if policy in runs else policy] = remat_run(cfg, policy, batches, device)
    again = differing(runs["none again"]["first"], runs["none"]["first"])
    if again:
        raise AssertionError(f"phase43: the step without REMAT is not deterministic: {again[:5]}")
    steps = 2 + REMAT_TIMED_STEPS  # the first, the timed ones, the profiled one
    for key, run in runs.items():
        diff = differing(run["first"], runs["none"]["first"])
        log(f"phase43 timing on {card}: TPU.REMAT={key}: {run['ms']:.2f} ms a step (median of "
            f"{REMAT_TIMED_STEPS}: {[round(v, 2) for v in run['times']]}), peak memory {run['peak_gib']:.3f} GiB "
            f"({run['step_gib']:.3f} GiB above what was allocated before the steps), profiler: "
            f"{run['device_ms']:.2f} ms of device time a step, {run['busy']:.3f} of the median step; "
            f"dW kernel launches {run['dw']} in {steps} steps; first step against 'none' bit for bit: "
            f"{'equal' if not diff else diff[:3]} (losses {float(run['first']['metrics']['total_loss']):.6f})")
        if diff:
            raise AssertionError(f"phase43: REMAT={key} differs from the step without it: {diff[:5]}")
        if run["dw"] != 2 * steps:
            raise AssertionError(f"phase43: REMAT={key}: {run['dw']} dW kernel launches in {steps} steps")
    del batches
    torch.cuda.empty_cache()

    res = vis_cli
    log(f"phase43 training CLI with TPU.REMAT=full (phase 19's run): {len(res['losses'])} steps of batch {BATCH}, "
        f"losses {[round(v, 3) for v in res['losses']]}, dW kernel launches {res['dw_launches']}, SyncBN "
        f"all-reduces in forward passes {res['syncbn_forward_allreduces']} (the recompute's included)")
    if len(res["losses"]) != VIS_STEPS or not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"phase43: the CLI took {len(res['losses'])} steps, or a loss is not finite")
    if res["dw_launches"] != 2 * VIS_STEPS:
        raise AssertionError(f"phase43: {res['dw_launches']} dW kernel launches in the CLI's {VIS_STEPS} steps")
    log(f"phase43 ok ({time.time() - t0:.2f} s)")
    return {"runs": {k: {key: r[key] for key in ("ms", "peak_gib", "step_gib", "device_ms")}
                     for k, r in runs.items()},
            "dw": sum(r["dw"] for r in runs.values()) + res["dw_launches"]}


# --- DLA's stem convs on the stem kernel (phase 45) ---------------------------
# (batch, height, width) of the frames: the benchmark cells' batch of 128 at
# KITTI's 384x1280 canvas, and nuScenes' two samples of six cameras at 896x1664
STEM_CANVASES = ((128, HEIGHT, WIDTH), (NUSC_BATCH, 896, 1664))
STEM_CHECK_SLICE = 32  # images a comparison with the plain version holds at once


def stem_conv_check(y, x, weight, bias, stride):
    """bench_stem.stem_conv_error of the kernel's output `y` on `x`, taken
    over slices of STEM_CHECK_SLICE images: (max ulps, elements beyond the
    bound, share equal bit for bit)."""
    from dd3d_tpu_torch.bench_stem import stem_conv_error
    from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames

    worst, beyond, equal, n = 0.0, 0, 0.0, 0
    for i0 in range(0, y.shape[0], STEM_CHECK_SLICE):
        i1 = min(y.shape[0], i0 + STEM_CHECK_SLICE)
        xs = NormalizedFrames(x.frames[i0:i1], x.mean, x.std, x.dtype) if isinstance(x, NormalizedFrames) else x[i0:i1]
        e = stem_conv_error(y[i0:i1], xs, weight, bias, stride)
        worst, beyond = max(worst, e["max_ulps"]), beyond + e["beyond"]
        equal, n = equal + e["equal_share"] * e["elements"], n + e["elements"]
    return worst, beyond, equal / n


def cudnn_stem(x, weight, bias, stride):
    """The unfused ConvNorm on the card: cuDNN's bf16 conv, PyTorch's
    separate bias add, then the ReLU."""
    return torch.nn.functional.relu(torch.nn.functional.conv2d(x, weight, bias, stride, (weight.shape[-1] - 1) // 2))


def phase45_stem_conv(model, cfg, cfg8, images, intrinsics, device, card):
    """DLA's stem convs on the stem kernel (ops/stem_conv.py) at the shapes
    the serving path gives it: DLA-34's own folded bf16 weights, chained as
    the forward chains them from uint8 frames (`base_layer` on the frames,
    `level0` and `level1` on the kernel's outputs), at each of
    STEM_CANVASES; every output against stem_conv_plain within
    bench_stem.stem_conv_error's bound (at most 2 ulps, none beyond, at
    least 99.9 % equal bit for bit). At the first canvas, device time of the
    three kernels, of the plain version, and of cuDNN + bias + ReLU, with
    the three convs' bound (each reading its input and writing its output
    once). Then N_BATCHES served batches in bf16 and in static int8
    (QUANT_MIN_CH 32 leaves the stem in bf16), each counted from zero: 3
    kernel launches a forward in each. Returns (launches, max ulps, (ms,
    plain_ms, bound_ms, bound_by, library_ms))."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames, stem_conv, stem_conv_plain

    t0 = time.time()
    trunk = model.eval().backbone.bottom_up
    convs = []
    with torch.no_grad():
        for name in ("base_layer", "level0.0", "level1.0"):
            conv = trunk.get_submodule(name)
            weight, bias = conv._folded(*conv.norm.folded())
            convs.append((name, weight.to(torch.bfloat16), bias.to(torch.bfloat16), conv.stride))
    gen = torch.Generator(device=device).manual_seed(SEED + 45)
    prof = lambda: profile(activities=[ProfilerActivity.CUDA])  # noqa: E731
    worst_ulps, timed = 0.0, None
    for b, h, w in STEM_CANVASES:
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8, device=device)
        x = NormalizedFrames(frames, model.pixel_mean, model.pixel_std, torch.bfloat16)
        times = {"kernel": 0.0, "plain": 0.0, "cudnn": 0.0, "bound": 0.0}
        bys = set()
        with torch.inference_mode():
            for name, weight, bias, stride in convs:
                y = stem_conv(x, weight, bias, stride)
                ulps, beyond, equal = stem_conv_check(y, x, weight, bias, stride)
                log(f"phase45 {name} at {b}x{h}x{w}: kernel against plain: max {ulps:.3f} bf16 ulps, {beyond} "
                    f"elements beyond the bound, {equal:.6f} equal bit for bit")
                if ulps > 2 or beyond or equal < 0.999:
                    raise AssertionError(f"phase45: {name} at {b}x{h}x{w} strays from the plain version: {ulps} ulps, "
                                         f"{beyond} beyond, {equal} equal")
                worst_ulps = max(worst_ulps, ulps)
                if (b, h, w) == STEM_CANVASES[0]:
                    xt = x.normalized() if isinstance(x, NormalizedFrames) else x
                    times["kernel"] += device_ms(functools.partial(stem_conv, x, weight, bias, stride), 10, prof)
                    times["plain"] += device_ms(functools.partial(stem_conv_plain, x, weight, bias, stride), 2, prof)
                    times["cudnn"] += device_ms(functools.partial(cudnn_stem, xt, weight, bias, stride), 10, prof)
                    del xt
                    _, c, hi, wi = x.shape
                    o, k = weight.shape[0], weight.shape[-1]
                    ho, wo = y.shape[2], y.shape[3]
                    in_bytes = 1 if isinstance(x, NormalizedFrames) else 2
                    ms, by = bound_ms(b * hi * wi * c * in_bytes + b * ho * wo * o * 2, 2 * b * ho * wo * o * c * k * k,
                                      "bf16")
                    times["bound"] += ms
                    bys.add(by)
                x = y
        if (b, h, w) == STEM_CANVASES[0]:
            timed = (times["kernel"], times["plain"], times["bound"], "/".join(sorted(bys)), times["cudnn"])
            log(f"phase45 timing on {card}: the three stem convs at {b}x{h}x{w}, device time: kernels "
                f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, cuDNN + bias + ReLU {times['cudnn']:.4f} "
                f"ms; bound {times['bound']:.4f} ms by {timed[3]}")
        del frames, x, y
        torch.cuda.empty_cache()

    launches = {}
    for arm, arm_cfg in (("bf16", cfg), ("int8", cfg8)):
        infer = get_inference_fn(model, arm_cfg)
        stem_conv.launches = 0
        for im in images:
            infer(im, intrinsics)
        torch.cuda.synchronize()
        launches[arm] = stem_conv.launches
    log(f"phase45 stem kernel launches on {N_BATCHES} served batches of {BATCH}: {launches}")
    if launches != {"bf16": 3 * N_BATCHES, "int8": 3 * N_BATCHES}:
        raise AssertionError(f"phase45: stem kernel launches {launches}, want 3 a forward in bf16 and in static int8")
    log(f"phase45 ok ({time.time() - t0:.2f} s)")
    return launches, worst_ulps, timed


def main():
    modes = {"--cli-rank": cli_rank, "--cli-timing": cli_timing, "--eval-only": eval_only, "--vis-rank": vis_rank}
    if len(sys.argv) > 1 and sys.argv[1] in modes:
        modes[sys.argv[1]](sys.argv[2:])
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.kernels import build_libraries

    # cuBLAS reads it at its first handle: phase 43's deterministic steps need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    build_libraries("nms.cu", "quantize.cu", "int8_conv.cu", "conv_dw.cu", "stem_conv.cu", "imageio.cpp",
                    "kitti_eval.cpp")  # one compiler each
    log(f"kernels built in {time.time() - t0:.2f} s")
    from dd3d_tpu_torch.overfit_smoke import make_fixture

    tmp_dir = tempfile.TemporaryDirectory()
    root = make_fixture(os.path.join(tmp_dir.name, "fixture"), n_images=8)
    started = start_cli_children(tmp_dir.name, root)  # phases 5, 9 and 13 time after them

    nms_err, random_nms = phase1_kernel(device)
    torch.cuda.synchronize()

    cfg = get_experiment_cfg("dd3d_kitti_dla34")  # bf16 serving config
    model = build(cfg, device)
    images, intrinsics = make_batches(device)
    bf16_nms_launches, serving_nms = phase2_serve(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase3_plain_path(cfg, model, images, intrinsics)
    torch.cuda.synchronize()
    phase4_fp32(get_experiment_cfg("dd3d_kitti_dla34"), device)
    torch.cuda.synchronize()

    quant_err, quant_case = phase6_quantize(device)
    torch.cuda.synchronize()
    conv_err, sites, conv_cases, conv_case = phase7_int8_conv(model, images[0])
    torch.cuda.synchronize()
    cfg8, launches = phase8_int8_path(cfg, model, images, intrinsics, sites)
    torch.cuda.synchronize()
    dw_err, stem_cases = phase10_conv_dw(device)
    torch.cuda.synchronize()
    phase11_training(device)
    torch.cuda.synchronize()
    phase12_fp32_train(device)
    torch.cuda.synchronize()
    children = wait_cli_children(started)
    torch.cuda.empty_cache()

    imgs_per_s, nms_t = phase5_timing(cfg, model, images, intrinsics,
                                      {"random boxes": random_nms, "serving inputs": serving_nms})
    torch.cuda.synchronize()
    serving, kernel_ms = phase9_int8_timing(cfg8, cfg, model, images, intrinsics, quant_case, conv_case)
    int8_conv_sites_timing(conv_cases, cfg8.TPU.QUANT_MIN_CH)
    del conv_cases
    fusion = {"DLA-34": fusion_ab(model, cfg8, images, intrinsics, "phase9", card)}
    standalone = standalone_quantize_timing(model, cfg8, images, intrinsics, "phase9", card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stem_launches, stem_ulps, stem_t = phase45_stem_conv(model, cfg, cfg8, images, intrinsics, device, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    train_ms, train_peak, dw_ms = phase13_train_timing(device, stem_cases)
    torch.cuda.synchronize()
    with tmp_dir as tmp:
        cli_dw_launches, syncbn_per_step, run_dir = phase14_cli(root, children[14]["train"])
        torch.cuda.synchronize()
        loader_ips, cli_ms, synth_ms = phase15_cli_timing(tmp, root, card)
        torch.cuda.synchronize()
        eval_nms_launches = phase16_eval(root, run_dir, device, children[14]["eval"])
        torch.cuda.synchronize()
        overfit = phase17_overfit(children[17], card)
        evaluation = phase18_eval_scale(tmp, overfit["output_dir"], device, card)
        torch.cuda.synchronize()
        vis_cli = phase19_visualizers(tmp, root, card, children[19])
        tta = phase20_tta(tmp, overfit["output_dir"], device, card)
        torch.cuda.synchronize()

        v99_model, v99_bf16, v99_nms, v99_ips = phase21_v99_serve(device, images, intrinsics, card)
        torch.cuda.synchronize()
        v99_launches, v99_conv_err, v99_quant_err, v99_turns, v99_sums = phase22_v99_int8(
            v99_model, v99_bf16, images, intrinsics, device, card)
        del v99_model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        v99_train_ms, v99_train_peak = phase23_v99_train(device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        v99_eval_nms = phase24_v99_clis(tmp, device, card, children[24])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        nusc = phase25_nusc_serve(device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        phase4_fp32(experiment_cfg(NUSC), device, shape=(1, 256, 448), phase="phase26")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        nusc_eval_launches = phase27_nusc_eval(tmp, device, card, children[28])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        nusc_dw_launches, nusc_train_ms = phase28_nusc_train(card, children[28])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        large_err, large_nms, large_times = phase29_nms_large(device, images, intrinsics, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rg_model, rg_bf16, rg_nms, rg_ips = phase30_regnety_serve(device, images, intrinsics, card)
        torch.cuda.synchronize()
        rg_launches, rg_conv_err, grouped_err, grouped_t, rg_turns, grouped_sums = phase31_regnety_int8(
            rg_model, rg_bf16, images, intrinsics, device, tmp, card, children[31])
        del rg_model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rg_train_ms, rg_train_peak, rg_eval_nms = phase32_regnety_train(device, card, children[32])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dd_train_ms, dd_peak, dd_dw_launches = phase33_dense_depth_train(device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        nusc8, nusc8_v99 = phase36_nusc_int8(device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        nusc8_eval = phase37_nusc_int8_eval(tmp, device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dla_nms = phase38_dla_family(device, images, intrinsics, card)
        torch.cuda.synchronize()
        dx_launches, dx_conv_err, dx_grouped_errs, dx_sums, narrow_t, dx_batch_ms = phase39_dla_x_int8(
            device, images, intrinsics, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        dx_train_ms, dx_dw_launches = phase40_dla_x_train(device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ho_launches = phase41_head_options(device, images, intrinsics, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        jpeg = phase42_jpeg(tmp, device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        remat = phase43_remat(vis_cli, device, card)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kinds = phase44_new_kinds(tmp, device, card, jpeg["frame_ms"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    quant_err = max(quant_err, phase34_quantize_exhaustive(device))
    s8_err, s8_t = phase35_s8_epilogue(device, card)
    torch.cuda.synchronize()
    fusion.update({"V2-99": v99_launches["fusion"], "RegNetY": rg_launches["fusion"],
                   "DLA-34 v1 + per-level + class-agnostic": ho_launches["fusion"]})

    int8_ips = BATCH / (np.mean([r[0] for r in serving["int8"]]) / 1e3)
    bf16_ips = BATCH / (np.mean([r[0] for r in serving["bf16"]]) / 1e3)
    log(f"timing on {card}: bf16 {imgs_per_s:.1f} images/s (phase 5); phase 9 in turns: static int8 "
        f"{int8_ips:.1f} images/s, bf16 {bf16_ips:.1f} images/s (batch {BATCH}, {HEIGHT}x{WIDTH}); "
        f"NMS kernels' device time {nms_t['random boxes'][0]:.4f} ms vs plain {nms_t['random boxes'][1]:.4f} ms "
        f"at {NMS_SHAPE} on random boxes, {nms_t['serving inputs'][0]:.4f} ms on the serving inputs; NMS "
        f"launches on the bf16 path {bf16_nms_launches}")
    log(f"timing on {card}: train step at batch {BATCH}, {HEIGHT}x{WIDTH}, bf16: "
        f"{np.mean(train_ms['kernel']):.2f} ms with the dW kernel, {np.mean(train_ms['plain']):.2f} ms with the "
        f"plain dW; peak {train_peak:.2f} GiB; dW kernel {dw_ms[7, HEIGHT, WIDTH][0]:.4f} ms vs plain "
        f"{dw_ms[7, HEIGHT, WIDTH][1]:.4f} ms and cuDNN {dw_ms[7, HEIGHT, WIDTH][4]:.4f} ms at the 7x7 stem conv, "
        f"{dw_ms[3, HEIGHT, WIDTH][0]:.4f} ms vs cuDNN {dw_ms[3, HEIGHT, WIDTH][4]:.4f} ms at level0; at the CLI's "
        "buckets " + ", ".join(f"{h}x{w} k={k} {dw_ms[k, h, w][0]:.4f} ms" for h, w in BUCKET_CANVASES for k in (7, 3)))
    log(f"timing on {card}: train loader alone {loader_ips[False]:.1f} images/s (threads), {loader_ips[True]:.1f} "
        f"images/s (process pool); CLI step {cli_ms:.2f} ms with the loader vs {synth_ms:.2f} ms on synthetic "
        f"batches at bucket {TIMING_BUCKET}; SyncBN {syncbn_per_step} all-reduces a forward (as many in backward)")
    log(f"timing on {card}: evaluation {evaluation['images_per_s']:.2f} images/s over {evaluation['n_images']} "
        f"frames (loader, forward, decode, evaluators; the loader alone {evaluation['loader_images_per_s']:.2f}), "
        f"the R40 engine {evaluation['r40_s']:.4f} s; NMS launches on the eval path {eval_nms_launches} (phase 16), "
        f"{evaluation['nms_launches']} (phase 18); overfit run {OVERFIT_ITERS} steps: "
        f"{overfit['ms_step']:.2f} ms a step of batch 4, Car Moderate AP3D@0.5 {overfit['ap3d']:.2f}, BEV@0.5 "
        f"{overfit['bev']:.2f}, int8 worst |dAP| {overfit['dap']:.2f}, its arms' launches {overfit['launches']}")
    conv = tta["conv"]
    log(f"timing on {card}: TTA at full width over {TTA_IMAGES} frames, 5 scales with flip, buckets "
        f"{tta['buckets']}: bf16 {tta['bf16_images_per_s']:.2f} images/s (peak {tta['peak_gib']:.2f} GiB), static "
        f"int8 {tta['int8_images_per_s']:.2f} images/s (peak {tta['int8_peak_gib']:.2f} GiB, worst |dAP| "
        f"{tta['dap']:.4f}); {CAR_AP3D} plain {tta['plain_ap']:.4f}, tta/ {tta['tta_ap']:.4f}, at 384 "
        f"{tta['witness']['384'][0]:.4f}, 384+flip {tta['witness']['384+flip'][0]:.4f}, 5 scales without flip "
        f"{tta['witness']['5 scales'][0]:.4f}; launches on the TTA "
        f"path bf16 {tta['bf16_launches']}, int8 {tta['int8_launches']}; the int8 conv at the 640x1920 bucket's P3 "
        f"conv {conv['ms']:.4f} ms (cuDNN bf16 {conv['cudnn_ms']:.4f}, bound {conv['bound_ms']:.4f} by "
        f"{conv['bound_by']})")
    k_sum, c_sum, b_sum, n_sites = v99_sums["serving"]
    log(f"timing on {card}: {V99} (V-99-eSE, FPN 256, P3-P6) bf16 serving {v99_ips:.2f} images/s (phase 21); in "
        f"turns static int8 {v99_turns['int8']:.2f}, bf16 {v99_turns['bf16']:.2f} images/s (phase 22); its {n_sites} "
        f"int8 convs a forward {k_sum:.3f} ms of device time against cuDNN bf16 {c_sum:.3f} ms and the bound "
        f"{b_sum:.3f} ms; train step {v99_train_ms:.2f} ms at batch {BATCH}, peak {v99_train_peak:.2f} GiB "
        f"(phase 23); launches on the V2-99 paths: NMS {v99_nms} bf16 + {v99_launches['greedy_nms']} int8 + "
        f"{v99_eval_nms} EVAL_ONLY, quantize {v99_launches['quantize_int8']}, int8 conv "
        f"{v99_launches['int8_conv']}, dW 0")
    scan_samples = nusc["scan"][(2, 6 * 100)]
    log(f"timing on {card}: {NUSC} bf16 serving with the sample aggregation {nusc['images_per_s']:.2f} images/s at "
        f"batch {NUSC_BATCH} (phase 25; {nusc['dev_ms']:.3f} ms of device time a batch, busy {nusc['busy']:.3f}, "
        f"peak {nusc['peak_gib']:.2f} GiB); BEV scan " + ", ".join(
            f"{k}: {v[0]:.4f} ms (plain {v[1]:.4f})" for k, v in nusc["scan"].items())
        + f"; train step {nusc_train_ms:.2f} ms at batch {NUSC_TRAIN_BATCH}, {NUSC_TRAIN_SIZE} bucket (phase 28); "
        f"launches on the nuScenes paths: serving {nusc['launches']}, EVAL_ONLY {nusc_eval_launches}, dW "
        f"{nusc_dw_launches}")
    large = ", ".join(f"{k}: {v[0]:.4f} ms (plain {v[1]:.3f})" for k, v in large_times.items())
    log(f"timing on {card}: NMS past N = 2048 (phase 29; device time, kernel and plain) {large}; launches on "
        f"dd3d_kitti_dla34's serving with 1000 candidates a level: {large_nms}")
    g_ms, g_plain, g_bound, g_by, g_cudnn = grouped_t
    log(f"timing on {card}: {REGNETY} bf16 serving {rg_ips:.2f} images/s (phase 30); in turns static int8 "
        f"{rg_turns['int8']:.2f}, bf16 {rg_turns['bf16']:.2f} images/s (phase 31); its {grouped_sums['n']} grouped "
        f"int8 convs a forward {grouped_sums['own']:.4f} ms of device time on their own routes (direct "
        f"{grouped_sums['direct']:.4f} ms) against cuDNN bf16 grouped {grouped_sums['cudnn']:.4f} ms and the bound "
        f"{grouped_sums['bound']:.4f} ms; launches by route {rg_launches['int8_conv_grouped_by_route']}; at the "
        f"largest grouped shape "
        f"{g_ms:.4f} ms (cuDNN {g_cudnn:.4f}, bound {g_bound:.5f} by {g_by}); train step {rg_train_ms:.2f} ms at "
        f"batch {BATCH}, peak {rg_train_peak:.2f} GiB (phase 32); DD3DDenseDepth train step {dd_train_ms:.2f} ms, "
        f"peak {dd_peak:.2f} GiB, dW launches {dd_dw_launches} (phase 33)")
    for arm in ("int8", "bf16"):
        log(f"timing on {card}: {NUSC} {arm} serving with the aggregation (phase 36): "
            f"{NUSC_BATCH / np.mean(nusc8['ms'][arm]) * 1e3:.2f} images/s, {np.mean(nusc8['ms'][arm]):.3f} ms a batch, "
            f"{np.mean(nusc8['device_ms'][arm]):.3f} ms of device time a batch (in turns)")
    log(f"timing on {card}: {NUSC} int8 drift against bf16 (top-50 mean |diff|, score mass) {nusc8['drift']}, "
        f"{NUSC_V99} {nusc8_v99['drift']}; QUANT_MIN_CH 32 keeps in bf16: {NUSC} {nusc8['kept_bf16']}, {NUSC_V99} "
        f"{nusc8_v99['kept_bf16']}; the P3 tower conv (12, 112, 208, 256) with the s8 epilogue "
        f"{nusc8['p3_s8'][0]:.4f} ms, bf16 epilogue {nusc8['p3_s8'][5]:.4f} ms, cuDNN {nusc8['p3_s8'][4]:.4f} ms, "
        f"bound {nusc8['p3_s8'][2]:.4f} ms; at the TTA 1152 bucket {nusc8_eval['p3_shape']}: s8 "
        f"{nusc8_eval['p3_1152'][0]:.4f} ms, bf16 {nusc8_eval['p3_1152'][5]:.4f} ms, cuDNN "
        f"{nusc8_eval['p3_1152'][4]:.4f} ms, bound {nusc8_eval['p3_1152'][2]:.4f} ms")
    log(f"timing on {card}: {DLA_X} static int8 (phase 39): its {dx_sums['n']} grouped int8 convs a forward "
        f"{dx_sums['own']:.4f} ms of device time on their own routes (direct {dx_sums['direct']:.4f} ms) against "
        f"cuDNN bf16 grouped {dx_sums['cudnn']:.4f} ms and the bound {dx_sums['bound']:.4f} ms; launches by route "
        f"{dx_launches['int8_conv_grouped_by_route']}; the int8 batch's device time {dx_batch_ms['own']:.3f} ms on "
        f"the own routes, {dx_batch_ms['direct']:.3f} ms all on direct (medians of two turns); `narrow` at its "
        f"largest shape {narrow_t[0]:.4f} ms (cuDNN {narrow_t[4]:.4f}, bound {narrow_t[2]:.5f} by {narrow_t[3]}); "
        f"train step {dx_train_ms:.2f} ms (phase 40)")
    for name, ab in fusion.items():
        f, u = ab["fused"], ab["unfused"]
        log(f"timing on {card}: {name} static int8, tower links fused against unfused (in turns): quantize launches a "
            f"forward {u['launches']['quantize_int8']:.0f} -> {f['launches']['quantize_int8']:.0f}, int8 conv "
            f"s8 {f['launches']['int8_conv_s8']:.0f}, ReLU {u['launches']['relu']:.0f} -> {f['launches']['relu']:.0f}; "
            f"device time a batch {np.mean(u['device_ms']):.3f} -> {np.mean(f['device_ms']):.3f} ms; "
            f"{u['images_per_s']:.2f} -> {f['images_per_s']:.2f} images/s")
    log(f"timing on {card}: JPEG {JPEG_FRAME} {jpeg['frame_ms']:.3f} ms a frame on one host thread; {NUSC}'s test "
        f"loader {jpeg['loader_ips']['jpg']:.2f} images/s from JPEGs, {jpeg['loader_ips']['png']:.2f} from PNGs "
        f"(phase 42); TPU.REMAT train step (phase 43) " + ", ".join(
            f"{k} {v['ms']:.2f} ms ({v['device_ms']:.2f} of device time) / peak {v['peak_gib']:.3f} GiB "
            f"({v['step_gib']:.3f} above the steps' start)" for k, v in remat["runs"].items()))
    log(f"timing on {card}: ms a 375x1242 frame on one host thread (phase 44): " + ", ".join(
        f"{k} {v:.3f}" for k, v in kinds["frame_ms"].items()) + f"; baseline JPEG 900x1600 {jpeg['frame_ms']:.3f}")
    log(f"timing on {card}: the {standalone['n']} standalone quantizes of a fused DLA-34 int8 forward "
        f"{standalone['kernel']:.4f} ms of device time, the same-bytes cast {standalone['cast']:.4f} ms, bound "
        f"{standalone['bound']:.4f} ms; at {QUANT_SHAPE} bf16 {kernel_ms['quantize_int8'][0]:.4f} ms against "
        f"{kernel_ms['quantize_int8'][2]:.4f} by bytes; the P3 tower conv with the s8 epilogue {s8_t[0]:.4f} ms")
    int8_paths = (launches, v99_launches, rg_launches, nusc8["launches"], nusc8_v99["launches"], dx_launches,
                  ho_launches)
    launches = {"greedy_nms": launches["greedy_nms"] + v99_nms + v99_launches["greedy_nms"] + v99_eval_nms
                + nusc["launches"]["greedy_nms"] + nusc_eval_launches["greedy_nms"] + large_nms + rg_nms
                + rg_launches["greedy_nms"] + rg_eval_nms + nusc8["launches"]["greedy_nms"]
                + nusc8_v99["launches"]["greedy_nms"] + nusc8_eval["plain"]["greedy_nms"] + dla_nms
                + dx_launches["greedy_nms"] + ho_launches["greedy_nms"] + jpeg["launches"]["greedy_nms"]
                + kinds["launches"]["greedy_nms"],
                "greedy_nms_scan": nusc["launches"]["greedy_nms_scan"] + nusc_eval_launches["greedy_nms_scan"]
                + nusc8["launches"]["greedy_nms_scan"] + nusc8_v99["launches"]["greedy_nms_scan"]
                + nusc8_eval["plain"]["greedy_nms_scan"] + jpeg["launches"]["greedy_nms_scan"],
                "quantize_int8": sum(x["quantize_int8"] for x in int8_paths)
                + nusc8_eval["plain"]["quantize_int8"] + nusc8_eval["tta"]["quantize_int8"],
                "int8_conv": sum(x["int8_conv"] for x in int8_paths)
                + nusc8_eval["plain"]["int8_conv"] + nusc8_eval["tta"]["int8_conv"],
                "int8_conv_requant": sum(x["int8_conv_by_out"]["s8"] for x in int8_paths)
                + nusc8_eval["plain"]["int8_conv_s8"] + nusc8_eval["tta"]["int8_conv_s8"],
                # the narrow route has a row of its own
                "int8_conv_grouped": rg_launches["int8_conv_grouped"] + dx_launches["int8_conv_grouped"]
                - rg_launches["int8_conv_grouped_by_route"]["narrow"]
                - dx_launches["int8_conv_grouped_by_route"]["narrow"],
                "int8_conv_grouped_narrow": rg_launches["int8_conv_grouped_by_route"]["narrow"]
                + dx_launches["int8_conv_grouped_by_route"]["narrow"],
                "stem_conv": stem_launches["bf16"] + stem_launches["int8"]}
    quant_err = max(quant_err, v99_quant_err)
    conv_err = max(conv_err, v99_conv_err, rg_conv_err, nusc8["conv_err"], nusc8_v99["conv_err"], dx_conv_err)
    grouped_err = max([grouped_err] + [e for route, e in dx_grouped_errs.items() if route != "narrow"])
    timed = {"greedy_nms": (*nms_t["random boxes"], None), "greedy_nms_scan": (*scan_samples, None),
             "quantize_int8": kernel_ms["quantize_int8"], "int8_conv": kernel_ms["int8_conv"], "int8_conv_requant": s8_t,
             "int8_conv_grouped": grouped_t, "int8_conv_grouped_narrow": narrow_t,
             "conv_dw_s1_same": dw_ms[7, HEIGHT, WIDTH], "stem_conv": stem_t}
    rows = [("greedy_nms", "dd3d_tpu_torch/csrc/nms.cu", "dd3d_tpu/ops/pallas_nms.py:40", launches["greedy_nms"],
             max(nms_err, large_err)),
            ("greedy_nms_scan", "dd3d_tpu_torch/csrc/nms.cu", "dd3d_tpu/ops/nms.py:37",
             launches["greedy_nms_scan"], nusc["scan_err"]),
            ("quantize_int8", "dd3d_tpu_torch/csrc/quantize.cu", "scripts/bench_quantize_kernel.py:91",
             launches["quantize_int8"], quant_err),
            ("int8_conv", "dd3d_tpu_torch/csrc/int8_conv.cu", "dd3d_tpu/models/layers.py:246", launches["int8_conv"],
             conv_err),
            ("int8_conv_requant", "dd3d_tpu_torch/csrc/int8_conv.cu", "dd3d_tpu/models/layers.py:246",
             launches["int8_conv_requant"], s8_err),
            ("int8_conv_grouped", "dd3d_tpu_torch/csrc/int8_conv.cu", "dd3d_tpu/models/layers.py:273",
             launches["int8_conv_grouped"], grouped_err),
            ("int8_conv_grouped_narrow", "dd3d_tpu_torch/csrc/int8_conv.cu", "dd3d_tpu/models/layers.py:273",
             launches["int8_conv_grouped_narrow"], dx_grouped_errs["narrow"]),
            ("conv_dw_s1_same", "dd3d_tpu_torch/csrc/conv_dw.cu", "dd3d_tpu/ops/pallas_conv.py:58",
             cli_dw_launches + nusc_dw_launches + dd_dw_launches + dx_dw_launches + remat["dw"], dw_err),
            # no TPU kernel: the JAX package leaves these convs to XLA; its error is in bf16 ulps
            ("stem_conv", "dd3d_tpu_torch/csrc/stem_conv.cu", None, launches["stem_conv"], stem_ulps)]
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
