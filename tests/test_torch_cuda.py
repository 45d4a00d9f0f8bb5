"""Tests of the port that need an NVIDIA card and nvcc (marker `cuda`); they
skip without one. This file imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py sets up jax.)
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _random_boxes(rng, b, n):
    boxes = rng.rand(b, n, 4).astype(np.float32) * 200
    boxes[..., 2:] = boxes[..., :2] + rng.rand(b, n, 2).astype(np.float32) * 80 + 1
    return boxes, rng.rand(b, n) > 0.1


NMS_EDGE_CASES = ("tie", "chain", "chain-invalid", "identical", "zero-area", "all-invalid")


def nms_edge_case(name, n):
    """(boxes (2, n, 4) f32, valid (2, n) bool, keep the greedy walk must give
    or None) of an NMS edge case at threshold 0.5, for any n >= 1:
    - tie: pairs [10p, 0, 10p+2, 1], [10p, 0, 10p+1, 1] at IoU exactly 0.5,
      which does not suppress (the test is strict): every box is kept;
    - chain: [3k, 0, 3k+10, 1], IoU 7/13 with the next box, 4/16 with the one
      after: k suppresses k+1, which then cannot suppress k+2, so the even
      boxes are kept, across every 64-box word;
    - chain-invalid: the chain with boxes invalid in its middle, each of
      which flips the parity of the kept boxes after it;
    - identical: one box n times (in image 1 the first one invalid): only
      the first valid one is kept;
    - zero-area: IoU 0 everywhere: every valid box is kept;
    - all-invalid: nothing is kept."""
    k = np.arange(n)
    ones = np.ones((2, n), bool)
    if name == "tie":
        x0 = (10 * (k // 2)).astype(np.float32)
        box = np.stack([x0, 0 * x0, x0 + np.where(k % 2 == 0, 2, 1), 0 * x0 + 1], -1).astype(np.float32)
        return np.stack([box, box]), ones, ones
    if name in ("chain", "chain-invalid"):
        box = np.stack([3 * k, 0 * k, 3 * k + 10, 0 * k + 1], -1).astype(np.float32)
        valid = ones.copy()
        if name == "chain-invalid":
            valid[0, k % 63 == 4] = valid[1, k % 50 == 8] = False
        keep = np.zeros((2, n), bool)
        for img in range(2):
            last = -2  # the chain: k is kept unless k-1 is its kept, valid neighbour
            for i in range(n):
                keep[img, i] = valid[img, i] and last != i - 1
                last = i if keep[img, i] else last
        return np.stack([box, box]), valid, keep
    rng = np.random.RandomState(n)
    if name == "identical":
        valid = ones.copy()
        valid[1, 0] = False
        keep = np.zeros((2, n), bool)
        keep[0, 0] = True
        if n > 1:
            keep[1, 1] = True
        return np.broadcast_to(np.array([10, 10, 50, 40], np.float32), (2, n, 4)).copy(), valid, keep
    boxes, valid = _random_boxes(rng, 2, n)
    if name == "zero-area":
        boxes[..., 2] = boxes[..., 0]
        return boxes, valid, valid
    if name == "all-invalid":
        return boxes, ~ones, ~ones
    raise ValueError(name)


# N past 2048 runs the block scan: its first word, the reference's
# PRE_NMS_TOPK of 1000 at five levels (5000) and beyond
NMS_LARGE_SIZES = ((2, 2049), (2, 4096), (8, 5000), (1, 10000))


@pytest.mark.parametrize("b,n", [(8, 512), (3, 300), (1, 1), (2, 63), (2, 64), (2, 65), (1, 2048), *NMS_LARGE_SIZES])
def test_kernel_matches_plain(card, b, n):
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    boxes, valid = _random_boxes(np.random.RandomState(2), b, n)
    bt, vt = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    for thr in (0.5, 0.75):
        before = greedy_nms.launches
        keep = greedy_nms(bt, vt, thr)
        assert greedy_nms.launches == before + 1
        assert torch.equal(keep, greedy_nms_plain(bt, vt, thr))


@pytest.mark.parametrize("n", [1, 65, 300, 2048, 2049, 4096])
@pytest.mark.parametrize("name", NMS_EDGE_CASES)
def test_kernel_edge_cases(card, name, n):
    """Exact keep masks against the plain version and the greedy walk's
    known answer: ties at the threshold, chains across words, invalid boxes
    in a chain, identical and zero-area boxes, nothing valid."""
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    boxes, valid, want = nms_edge_case(name, n)
    bt, vt = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    keep = greedy_nms(bt, vt, 0.5)
    assert torch.equal(keep, greedy_nms_plain(bt, vt, 0.5))
    np.testing.assert_array_equal(keep.cpu().numpy(), want)


def test_kernel_rejects_too_many_boxes(card):
    """No N limit of the kernels' own is left: what bounds N is the
    (B, N, ceil(N/64)) int64 scratch. At N = 2^20 it is 128 GiB, more than
    the card holds, and its allocation raises before anything launches."""
    from dd3d_tpu_torch.ops import nms_kernel
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    assert not hasattr(nms_kernel._library(), "dd3d_nms_max_n")
    n = 2 ** 20
    before = greedy_nms.launches
    with pytest.raises(torch.OutOfMemoryError):
        greedy_nms(torch.zeros(1, n, 4, device=card), torch.ones(1, n, dtype=torch.bool, device=card), 0.5)
    assert greedy_nms.launches == before


def scan_case(rng, b, n):
    """A score-sorted suppression matrix as the rotated BEV NMS hands it to
    the scan: most pairs far below 0.5, some above, a lattice of pairs at
    exactly 0.5 (not suppressed: the test is strict), and invalid boxes."""
    iou = (rng.rand(b, n, n) ** 8).astype(np.float32)
    iou[:, ::7, ::5] = 0.5
    return iou, rng.rand(b, n) > 0.1


@pytest.mark.parametrize("b,n", [(12, 100), (2, 600), (1, 2048), (3, 65), (1, 1), (1, 2049), (2, 4096),
                                 (1, 5000)])
def test_scan_kernel_matches_plain(card, b, n):
    """The pack + scan kernels (ops/nms_kernel.greedy_nms_scan) against the
    plain greedy fixpoint, exactly: the per-image BEV NMS's (B, 100), a
    sample's (2, 600), the kernel's largest N, a ragged word, one box."""
    from dd3d_tpu_torch.ops.nms import greedy_suppress
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_scan

    iou, valid = scan_case(np.random.RandomState(n), b, n)
    it, vt = torch.from_numpy(iou).to(card), torch.from_numpy(valid).to(card)
    for thr in (0.3, 0.5):
        before = greedy_nms_scan.launches
        keep = greedy_nms_scan(it, vt, thr)
        assert greedy_nms_scan.launches == before + 1
        want = greedy_suppress(it, vt, thr)
        assert torch.equal(keep, want)
        np.testing.assert_array_equal(keep.cpu().numpy(), greedy_suppress(*map(torch.from_numpy, (iou, valid)), thr))
        assert int(keep.sum()) <= int(vt.sum()) and bool(keep.any()) == bool(vt.any())  # the first valid box stays


def test_scan_kernel_rejects_what_it_does_not_take(card):
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_scan

    with pytest.raises(ValueError, match="need iou"):
        greedy_nms_scan(torch.zeros(1, 8, 9, device=card), torch.ones(1, 8, dtype=torch.bool, device=card), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        greedy_nms_scan(torch.zeros(1, 8, 8, device=card).transpose(1, 2),
                        torch.ones(1, 8, dtype=torch.bool, device=card), 0.5)


def test_slice_on_card_matches_cpu(card):
    """The fp32 slice on the card (TF32 off, NMS through the kernel) against
    the CPU: same valid set; sorted scores within 1e-3 (summation order)."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    images = (np.random.RandomState(4).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    det_cpu = get_inference_fn(model, cfg)(images, intrinsics)
    det_gpu = get_inference_fn(model.to(card), cfg)(images, intrinsics)
    np.testing.assert_array_equal(det_gpu["valid"].cpu().numpy(), det_cpu["valid"].numpy())
    np.testing.assert_allclose(det_gpu["scores"].cpu().numpy(), det_cpu["scores"].numpy(), atol=1e-3)


@pytest.mark.parametrize("shape,dtype,amax", [
    ((8, 48, 160, 256), torch.bfloat16, None),
    ((8, 48, 160, 256), torch.bfloat16, 4.0),
    ((3, 7, 13, 5), torch.float32, None),
    ((2, 9, 17, 16), torch.float32, 15.875),
])
def test_quantize_kernel_matches_plain(card, shape, dtype, amax):
    """Exact int8 codes; with amax 15.875 (xs = 0.125) every input is an
    exact .5 tie and a third of them clip."""
    from dd3d_tpu_torch.ops.int8_conv import activation_scale
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    rng = np.random.RandomState(5)
    if amax == 15.875:
        x = (rng.randint(-200, 200, size=shape) + 0.5) * 0.125
    else:
        x = rng.randn(*shape) * 3
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype).to(card)
    xs = activation_scale(xt, amax)
    before = quantize_int8.launches
    q = quantize_int8(xt, xs)
    assert quantize_int8.launches == before + 1
    assert torch.equal(q, quantize_int8_plain(xt, xs))


# scales of the quantize checks: static scales of amaxes like the path's
# calibrated ones, powers of two, and log-uniform random ones
QUANT_AMAXES = (0.37, 1.9, 4.0, 7.3, 15.875, 31.2, 96.5, 250.0)
QUANT_SCALES = ([float(np.float32(a) / np.float32(127)) for a in QUANT_AMAXES]
                + [2.0 ** e for e in (-20, -7, -1, 0, 3, 10)]
                + [float(np.float32(v)) for v in np.exp(np.random.RandomState(5).uniform(-12, 6, 6))])


def _all_bf16(card):
    """The 65,536 bf16 bit patterns but the NaNs, on the card."""
    bits = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return bits[~torch.isnan(bits)].to(card)


def test_quantize_kernel_equals_plain_on_every_bf16_value(card):
    """Every non-NaN bf16 value at 20 scales: the kernel's division-free
    codes (csrc/quantize.cuh) equal the plain version's division."""
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    x = _all_bf16(card)
    assert x.numel() == 65536 - 254
    wide = x.repeat(80)  # 5.2M elements: the 16-a-thread kernel (65,282 take the 8-a-thread one)
    for xs_value in QUANT_SCALES:
        xs = torch.tensor([xs_value], dtype=torch.float32, device=card)
        for t in (x, x.float(), wide):
            q = quantize_int8(t, xs)
            assert torch.equal(q, quantize_int8_plain(t, xs)), f"xs={xs_value!r} {t.dtype} {t.numel()}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_ragged_and_unaligned(card, dtype):
    """Sizes around the 8- and 16-element packets, the 8-a-thread kernel
    and the 16-a-thread one (from ~4.3M elements) with ragged tails, and
    bases 1..15 elements past an aligned one (the element-by-element
    path)."""
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    gen = torch.Generator().manual_seed(8)
    flat = (torch.randn(2 ** 23 + 77, generator=gen) * 4).to(dtype).to(card)
    xs = torch.tensor([QUANT_SCALES[2]], dtype=torch.float32, device=card)
    for n in (1, 7, 8, 9, 15, 16, 17, 31, 255, 4097, 2 ** 20 + 3, 2 ** 22 + 5, 2 ** 23 + 9, flat.numel()):
        assert torch.equal(quantize_int8(flat[:n], xs), quantize_int8_plain(flat[:n], xs)), n
    for offset in range(1, 16):
        for n in (100003, 5000003):
            x = flat[offset:offset + n]
            assert torch.equal(quantize_int8(x, xs), quantize_int8_plain(x, xs)), (offset, n)
    x = flat[: 3 * 7 * 13 * 5].view(3, 7, 13, 5)
    assert torch.equal(quantize_int8(x, xs), quantize_int8_plain(x, xs))


# the head towers' int8 conv shapes at batch 8, 384x1280: (H, W) of each
# level and the tower width of DLA-34 (P3-P7, 256), V2-99 (P3-P6, 256) and
# RegNetY + BiFPN (P3-P7, 160); V2-99's are DLA-34's first four
TOWER_LEVELS = ((48, 160), (24, 80), (12, 40), (6, 20), (3, 10))
TOWER_SHAPES = [(8, h, w, c) for c in (256, 160) for h, w in TOWER_LEVELS] + [(3, 7, 11, 256)]  # + a ragged M


@pytest.mark.parametrize("b,h,w,c", TOWER_SHAPES)
def test_int8_conv_s8_epilogue_matches_plain(card, b, h, w, c):
    """The s8 epilogue (ReLU and the next quantize in the int8 conv) against
    `int8_conv_requant_plain`, bit for bit, after a bf16 and an f32
    epilogue, at a scale that clips some codes; counted as s8 launches."""
    from dd3d_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain, int8_conv_requant_plain

    rng = np.random.RandomState(9)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)).to(card)
    wq = torch.from_numpy(rng.randint(-127, 128, (c, 3, 3, c)).astype(np.int8)).to(card)
    scale = torch.from_numpy((rng.rand(c) * 1e-4 + 1e-5).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32)).to(card)
    for dt in (torch.bfloat16, torch.float32):
        y = int8_conv_plain(xq, wq, scale, bias, 1, 1, dt)
        xs_next = (y.float().amax() * 0.8 / 127).reshape(1)
        before = (int8_conv.launches, dict(int8_conv.launches_by_out))
        got = int8_conv(xq, wq, scale, bias, 1, 1, dt, requant=xs_next)
        want = int8_conv_requant_plain(xq, wq, scale, bias, 1, 1, dt, xs_next)
        assert got.dtype == torch.int8 and got.shape == (b, h, w, c)
        assert torch.equal(got, want), dt
        assert (want == 127).any() and (want == 0).any()
        assert int8_conv.launches == before[0] + 1
        assert int8_conv.launches_by_out == dict(before[1], s8=before[1]["s8"] + 1)


@pytest.mark.parametrize("b,h,w,c,o,k,stride", [
    (2, 24, 40, 256, 256, 3, 1),  # a head-tower conv
    (2, 33, 47, 3, 16, 7, 1),     # the stem, ragged: C padded to 16
    (2, 24, 40, 64, 5, 3, 1),     # a fused predictor: O = 5
    (2, 25, 41, 128, 55, 3, 2),   # O = 55, stride 2, odd sizes
    (1, 12, 20, 1280, 512, 1, 1),  # the widest root concat
    (2, 13, 21, 32, 10, 3, 1),    # O = 10, M = 546 (not a multiple of 128)
    (1, 9, 15, 64, 64, 1, 1),     # O = 64: the 64-wide tile, M = 135
    (2, 17, 19, 48, 128, 3, 2),   # O = 128, stride 2, K = 432 (not a multiple of 128)
    (1, 11, 13, 256, 256, 3, 1),  # O = 256, M = 143
    (1, 10, 14, 12, 24, 3, 1),    # C = 12 padded to 16
])
def test_int8_conv_kernel_matches_plain(card, b, h, w, c, o, k, stride):
    """Exact int32 accumulators (f32 out at scale 1 holds them exactly below
    2^24) and the bf16 / f32 epilogues bit for bit."""
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv, int8_conv_acc_plain

    rng = np.random.RandomState(6)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)).to(card)
    wq = torch.from_numpy(rng.randint(-127, 128, (o, k, k, c)).astype(np.int8)).to(card)
    scale = torch.from_numpy((rng.rand(o) * 1e-3 + 1e-5).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.randn(o).astype(np.float32)).to(card)
    pad = (k - 1) // 2
    acc = int8_conv_acc_plain(xq, wq, stride, pad)
    assert int(acc.abs().max()) < 2 ** 24
    before = int8_conv.launches
    assert torch.equal(int8_conv(xq, wq, torch.ones_like(scale), None, stride, pad, torch.float32), acc.float())
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(int8_conv(xq, wq, scale, bias, stride, pad, dt), dequant_plain(acc, scale, bias, dt))
    assert int8_conv.launches == before + 3


# dd3d_kitti_v99's distinct int8 conv shapes (V-99-eSE: the stem's s2 and s1
# convs, the OSA 3x3 links with C and O in 128..256, K = 9C with tails of
# 32, 64 and 96 bytes against the 128-byte K stage, O = 160 and 224 filling
# part of an N tile, and the 1x1 concat convs of C = 768..1888), small grids.
V99_CONV_SHAPES = [
    (2, 33, 41, 3, 64, 3, 2),      # stem1, C = 3 padded to 16, stride 2
    (2, 17, 21, 64, 64, 3, 1),     # stem2
    (2, 17, 21, 64, 128, 3, 2),    # stem3
    (2, 12, 20, 128, 128, 3, 1),   # stage 2 links
    (2, 12, 20, 256, 160, 3, 1),   # stage 3's first link: K = 2304
    (2, 12, 20, 160, 160, 3, 1),   # K = 1440, O = 160
    (2, 6, 10, 192, 192, 3, 1),    # K = 1728
    (2, 6, 10, 224, 224, 3, 1),    # K = 2016, O = 224
    (2, 12, 20, 768, 256, 1, 1),   # stage 2 concat
    (2, 12, 20, 1056, 512, 1, 1),  # stage 3 concat
    (1, 6, 10, 1472, 768, 1, 1),   # stage 4 concat
    (1, 3, 5, 1888, 1024, 1, 1),   # stage 5 concat
]


@pytest.mark.parametrize("b,h,w,c,o,k,stride", V99_CONV_SHAPES)
def test_int8_conv_kernel_matches_plain_at_v99_shapes(card, b, h, w, c, o, k, stride):
    test_int8_conv_kernel_matches_plain(card, b, h, w, c, o, k, stride)


# every distinct grouped int8 conv of the dd3d_kitti_regnety_006_bifpn
# forward at 384x1280 (batch 1 here): RegNetY-006's Y-block `b` convs (C/g =
# 16; stride 2 in each stage's first block) and BiFPN's depthwise `dw` convs
# (C/g = 1) at P3-P7, 160 channels
REGNETY_GROUPED_SHAPES = [
    (1, 192, 640, 48, 3, 2),   # s1_b0/b
    (1, 96, 320, 112, 7, 2),   # s2_b0/b
    (1, 48, 160, 112, 7, 1),   # s2_b1..2/b
    (1, 48, 160, 256, 16, 2),  # s3_b0/b
    (1, 24, 80, 256, 16, 1),   # s3_b1..6/b
    (1, 24, 80, 608, 38, 2),   # s4_b0/b
    (1, 12, 40, 608, 38, 1),   # s4_b1..3/b
    (1, 48, 160, 160, 160, 1),  # P3 dw
    (1, 24, 80, 160, 160, 1),   # P4 dw
    (1, 12, 40, 160, 160, 1),   # P5 dw
    (1, 6, 20, 160, 160, 1),    # P6 dw
    (1, 3, 10, 160, 160, 1),    # P7 dw
]


def _grouped_case(card, b, h, w, c, o, g, stride, seed):
    rng = np.random.RandomState(seed)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)).to(card)
    wq = torch.from_numpy(rng.randint(-127, 128, (o, 3, 3, c // g)).astype(np.int8)).to(card)
    scale = torch.from_numpy((rng.rand(o) * 1e-3 + 1e-5).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.randn(o).astype(np.float32)).to(card)
    return xq, wq, scale, bias


def _check_grouped_route(xq, wq, scale, bias, stride, g, route, launches_per_call=1):
    """The `route` kernel's int32 accumulators and bf16 / f32 epilogues bit
    for bit against the plain version, each launch counted on its route."""
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv_grouped, int8_conv_grouped_acc_plain

    acc = int8_conv_grouped_acc_plain(xq, wq, stride, 1, g)
    before = int8_conv_grouped.launches
    by_route = dict(int8_conv_grouped.launches_by_route)
    assert torch.equal(int8_conv_grouped(xq, wq, torch.ones_like(scale), None, stride, 1, torch.float32, g,
                                         route=route), acc.float())
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(int8_conv_grouped(xq, wq, scale, bias, stride, 1, dt, g, route=route),
                           dequant_plain(acc, scale, bias, dt))
    torch.cuda.synchronize()
    assert int8_conv_grouped.launches == before + 3 * launches_per_call
    expected = dict(by_route, **{route: by_route[route] + 3 * launches_per_call})
    assert int8_conv_grouped.launches_by_route == expected


@pytest.mark.parametrize("b,h,w,c,g,stride", REGNETY_GROUPED_SHAPES + [
    (2, 13, 17, 24, 6, 2),  # C/g = 4, ragged
    (2, 9, 11, 12, 4, 1),   # C/g = 3: no 4-channel packs
    (1, 7, 9, 8, 2, 1),     # O = 2 C: two outputs a group
])
def test_int8_conv_grouped_kernel_matches_plain(card, b, h, w, c, g, stride):
    """Exact int32 accumulators and the bf16 / f32 epilogues bit for bit, on
    the route the dispatcher picks and on `direct`, which every shape admits."""
    from dd3d_tpu_torch.ops.int8_conv import grouped_routes

    o = 2 * c if c == 8 else c
    case = _grouped_case(card, b, h, w, c, o, g, stride, c + g)
    for route in grouped_routes(c, o, 3, 3, stride, g):
        _check_grouped_route(*case, stride, g, route)


# every distinct grouped int8 conv of a DLA-X-60 forward at 384x1280 (batch
# 1 here): BottleneckX's 3x3, cardinality 32, so C/g = O/g = 4, 8, 16 and 32
# at levels 2-5, stride 2 in each level's first block
DLAX_GROUPED_SHAPES = [
    (1, 192, 640, 128, 2, "narrow"),  # level2, C/g = 4
    (1, 96, 320, 128, 1, "narrow"),
    (1, 96, 320, 256, 2, "narrow"),   # level3, C/g = 8
    (1, 48, 160, 256, 1, "narrow"),
    (1, 48, 160, 512, 2, "mma"),      # level4, C/g = 16
    (1, 24, 80, 512, 1, "mma"),
    (1, 24, 80, 1024, 2, "mma"),      # level5, C/g = 32
    (1, 12, 40, 1024, 1, "mma"),
]


@pytest.mark.parametrize("b,h,w,c,stride,route", DLAX_GROUPED_SHAPES)
def test_int8_conv_grouped_kernel_matches_plain_at_dlax_shapes(card, b, h, w, c, stride, route):
    """DLA-X's grouped shapes on the route they take, and on `direct`, bit
    for bit: C/g = 32 is the mma route's widest group, which no RegNetY conv
    reaches; C/g = 4 and 8 run the narrow kernel on a model's path."""
    from dd3d_tpu_torch.ops.int8_conv import grouped_routes

    assert grouped_routes(c, c, 3, 3, stride, 32)[0] == route
    case = _grouped_case(card, b, h, w, c, c, 32, stride, c + stride)
    for r in grouped_routes(c, c, 3, 3, stride, 32):
        _check_grouped_route(*case, stride, 32, r)


@pytest.mark.parametrize("b,h,w,c,o,g,stride,route", [
    (2, 13, 37, 32, 32, 32, 1, "depthwise"),    # H and W that no 8 x 32 tile divides
    (2, 21, 70, 48, 48, 48, 2, "depthwise"),    # stride 2; C = 48: a half-filled run of 32 channels
    (1, 9, 33, 160, 160, 160, 1, "depthwise"),  # batch 1
    (1, 5, 3, 16, 16, 16, 2, "depthwise"),      # a tile larger than the image
    (2, 20, 36, 64, 64, 2, 1, "mma"),           # C/g = 32
    (2, 16, 24, 64, 32, 4, 1, "mma"),           # O/g = 8: one n8 tile
    (2, 12, 20, 48, 72, 3, 2, "mma"),           # O/g = 24: a pass of two n8 tiles, then one
    (2, 23, 45, 64, 64, 4, 2, "mma"),           # odd H and W at stride 2
    (1, 11, 19, 112, 112, 7, 1, "mma"),         # 7 groups: a run of 4, then a ragged run of 3
    (2, 13, 37, 64, 64, 16, 1, "narrow"),       # C/g = 4; H and W that no 8 x 32 tile divides
    (2, 23, 45, 64, 64, 8, 2, "narrow"),        # C/g = 8; odd H and W at stride 2
    (1, 9, 33, 128, 128, 32, 1, "narrow"),      # batch 1
    (1, 5, 3, 32, 32, 8, 2, "narrow"),          # a tile larger than the image
    (2, 12, 20, 64, 64, 32, 1, "narrow"),       # C/g = 2: two groups a word
    (2, 11, 19, 64, 64, 32, 2, "narrow"),       # C/g = 2 at stride 2
    (2, 10, 18, 256, 256, 64, 2, "narrow"),     # 64 groups, C/g = 4
    (1, 9, 14, 512, 512, 64, 1, "narrow"),      # 64 groups, C/g = 8
    (2, 11, 21, 48, 48, 6, 1, "narrow"),        # C = 48: a half-filled run of 32 channels
    (1, 7, 9, 16, 16, 8, 2, "narrow"),          # C = 16, C/g = 2: one half-filled run
    (2, 9, 11, 12, 12, 4, 1, "direct"),         # C/g = 3
    (2, 13, 17, 24, 24, 6, 2, "direct"),        # C/g = 4, C % 16 != 0
    (1, 7, 9, 8, 16, 2, 1, "direct"),           # O = 2 C
])
def test_int8_conv_grouped_route_edges(card, b, h, w, c, o, g, stride, route):
    """Each route at its edges, and `direct` on the same case, bit for bit,
    and the dispatcher's choice."""
    from dd3d_tpu_torch.ops.int8_conv import grouped_route, grouped_routes

    assert grouped_route(c, o, 3, 3, stride, g) == route
    case = _grouped_case(card, b, h, w, c, o, g, stride, b + h + c)
    for r in grouped_routes(c, o, 3, 3, stride, g):
        _check_grouped_route(*case, stride, g, r)


@pytest.mark.parametrize("c,o,g,stride,route", [(32, 32, 32, 2, "depthwise"), (64, 64, 4, 2, "mma"),
                                                 (64, 64, 16, 2, "narrow"), (48, 48, 6, 1, "narrow"),
                                                 (24, 24, 6, 1, "direct")])
def test_int8_conv_grouped_routes_on_runs_of_images(card, monkeypatch, c, o, g, stride, route):
    """A batch split by `batch_chunks` into runs of 2 images (as past 2^31
    elements): one launch a run, each run's pointers where they belong."""
    from dd3d_tpu_torch.ops import int8_conv as mod

    chunks = mod.batch_chunks
    monkeypatch.setattr(mod, "batch_chunks", lambda batch, per_image: chunks(batch, per_image, 2 * per_image))
    _check_grouped_route(*_grouped_case(card, 5, 14, 22, c, o, g, stride, c + o), stride, g, route,
                         launches_per_call=3)


def test_int8_conv_grouped_rejects_a_route_the_shape_does_not_take(card):
    from dd3d_tpu_torch.ops.int8_conv import int8_conv_grouped

    xq, wq, scale, _ = _grouped_case(card, 1, 8, 8, 24, 24, 6, 1, 0)
    with pytest.raises(ValueError, match="route"):
        int8_conv_grouped(xq, wq, scale, None, 1, 1, torch.float32, 6, route="mma")
    with pytest.raises(ValueError, match="route"):  # C/g = 4, but C % 16 != 0
        int8_conv_grouped(xq, wq, scale, None, 1, 1, torch.float32, 6, route="narrow")
    shifted = torch.zeros(8 * 8 * 64 + 1, dtype=torch.int8, device=card)[1:].view(1, 8, 8, 64)  # 1 byte off
    for g, route in ((4, "mma"), (16, "narrow")):
        _, wq, scale, _ = _grouped_case(card, 1, 8, 8, 64, 64, g, 1, 0)
        with pytest.raises(ValueError, match="aligned"):
            int8_conv_grouped(shifted, wq, scale, None, 1, 1, torch.float32, g, route=route)


def test_int8_conv_dequant_kernel_path_matches_plain(card):
    """The whole int8 conv (scales, quantize, conv, epilogue) through the
    kernels against the plain versions, on an NCHW-contiguous input (the
    wrapper copies it to NHWC) and a channels_last one."""
    from dd3d_tpu_torch.ops.int8_conv import int8_conv_dequant

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 64, 30, 50, generator=gen).to(card, torch.bfloat16)
    weight = torch.randn(96, 64, 3, 3, generator=gen).to(card)
    bias = torch.randn(96, generator=gen).to(card)
    for inp in (x, x.to(memory_format=torch.channels_last)):
        for amax in (None, 2.5):
            got = int8_conv_dequant(inp, weight, bias, 1, 1, torch.bfloat16, amax)
            assert torch.equal(got, int8_conv_dequant(inp, weight, bias, 1, 1, torch.bfloat16, amax, plain=True))
            assert got.is_contiguous(memory_format=torch.channels_last)
    grouped = torch.randn(64, 16, 3, 3, generator=gen).to(card)  # 4 groups
    for amax in (None, 2.5):
        got = int8_conv_dequant(x, grouped, None, 2, 1, torch.bfloat16, amax, groups=4)
        assert torch.equal(got, int8_conv_dequant(x, grouped, None, 2, 1, torch.bfloat16, amax, plain=True, groups=4))


def test_int8_kernels_reject_what_they_do_not_take(card):
    from dd3d_tpu_torch.ops.int8_conv import int8_conv
    from dd3d_tpu_torch.ops.quantize import quantize_int8

    xq = torch.zeros(1, 8, 8, 16, dtype=torch.int8, device=card)
    wq = torch.zeros(4, 3, 3, 16, dtype=torch.int8, device=card)
    ones = torch.ones(4, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv(xq.transpose(1, 2), wq, ones, None, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_int8(torch.zeros(4, 4, device=card).t(), torch.ones(1, device=card))


def _dw_case(card, b, h, w, ci, co, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, ci, generator=gen).to(card, dtype).permute(0, 3, 1, 2)  # channels_last NCHW
    dy = torch.randn(b, h, w, co, generator=gen).to(card, dtype).permute(0, 3, 1, 2)
    return x, dy


@pytest.mark.parametrize("b,h,w,ci,co,k,dtype", [
    (2, 96, 320, 3, 16, 7, torch.bfloat16),   # the stem's base_layer, smaller canvas
    (2, 96, 320, 16, 16, 3, torch.bfloat16),  # level0
    (2, 48, 160, 64, 64, 3, torch.bfloat16),  # CO over one 16-channel slice, M over one 160-row slice
    (2, 37, 45, 3, 16, 7, torch.bfloat16),    # ragged tiles; W*CI % 8 != 0: W padded by the wrapper
    (1, 19, 50, 16, 16, 3, torch.bfloat16),   # ragged tiles, nothing padded
    (2, 21, 35, 64, 64, 3, torch.bfloat16),   # ragged, M = 576 in 4 slices, CO in 4
    (1, 15, 20, 5, 7, 9, torch.bfloat16),     # CO = 7, 9x9: W and CO padded by the wrapper
    (3, 37, 53, 5, 7, 9, torch.float32),      # ragged tiles, 9x9, CO padded
    (1, 9, 40, 130, 4, 3, torch.float32),     # M = 1170: two slices of 1024 rows
    (2, 29, 70, 3, 16, 7, torch.float32),     # the stem on the CUDA cores, ragged
])
def test_conv_dw_kernel_matches_plain(card, b, h, w, ci, co, k, dtype):
    """Within 1e-5 of sum|x*dy| of each output (f32 sums in other orders),
    and two launches give identical bits (no atomics, a fixed grid)."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same, conv_dw_s1_same_plain

    x, dy = _dw_case(card, b, h, w, ci, co, dtype, seed=b * h + k)
    before = conv_dw_s1_same.launches
    got = conv_dw_s1_same(x, dy, k)
    again = conv_dw_s1_same(x, dy, k)
    assert conv_dw_s1_same.launches == before + 2
    assert torch.equal(got, again)
    want = conv_dw_s1_same_plain(x, dy, k)
    bound = conv_dw_s1_same_plain(x.abs(), dy.abs(), k)
    assert ((got - want).abs() <= 1e-5 * bound).all()


@pytest.mark.parametrize("offset", [1, 8])
def test_conv_dw_kernel_bits_do_not_depend_on_alignment(card, offset):
    """bf16 inputs `offset` elements into their storage (2 bytes: copied by
    the wrapper; 16 bytes: staged in place) give the bits of the same data
    in fresh storage: the grid and the order of the sums follow the shape
    alone."""
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same

    b, h, w, ci, co, k = 2, 40, 96, 16, 16, 3
    gen = torch.Generator().manual_seed(offset)
    xs = torch.randn(b * h * w * ci + offset, generator=gen).to(card, torch.bfloat16)
    x = xs[offset:].view(b, h, w, ci).permute(0, 3, 1, 2)
    dy = torch.randn(b, h, w, co, generator=gen).to(card, torch.bfloat16).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 == (0 if offset == 8 else 2)
    assert torch.equal(conv_dw_s1_same(x, dy, k), conv_dw_s1_same(x.clone(memory_format=torch.channels_last), dy, k))


def test_conv2d_s1_same_gradients_match_autograd(card):
    """Conv2dS1Same's dx and dW on the card against autograd through
    F.conv2d, in f32 with TF32 off."""
    from dd3d_tpu_torch.ops.conv_dw import Conv2dS1Same

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, _ = _dw_case(card, 2, 40, 72, 16, 16, torch.float32, seed=3)
    w = torch.randn(16, 16, 3, 3, device=card) * 0.1
    grads = []
    for fn in (lambda a, b: Conv2dS1Same.apply(a, b), lambda a, b: torch.nn.functional.conv2d(a, b, padding=1)):
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        torch.sin(fn(xa, wa)).sum().backward()
        grads.append((xa.grad, wa.grad))
    (dx_k, dw_k), (dx_r, dw_r) = grads
    torch.testing.assert_close(dx_k, dx_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw_k, dw_r, rtol=1e-4, atol=1e-4)


def test_conv_dw_kernel_rejects_what_it_does_not_take(card):
    from dd3d_tpu_torch.ops.conv_dw import conv_dw_s1_same

    x, dy = _dw_case(card, 1, 8, 8, 4, 4, torch.float32, seed=0)
    with pytest.raises(ValueError, match="channels_last"):
        conv_dw_s1_same(x.contiguous(), dy, 3)
    with pytest.raises(ValueError, match="shared memory"):
        big, dbig = _dw_case(card, 1, 4, 4, 2048, 4, torch.float32, seed=0)
        conv_dw_s1_same(big, dbig, 9)


def test_every_image_kind_on_card(card):
    """chip_smoke.py phase 44's digests: on the machine with the card (no
    cv2, libpng or libjpeg), every PNG fixture (tests/data/png: gAMA,
    palette, low-bit gray, Adam7, 16-bit) and every JPEG fixture
    (tests/data/jpeg: arithmetic-coded, CMYK/YCCK, smoothed progressive,
    cut inside a marker segment) decodes to the SHA-256 of the JAX
    package's read_image_bgr, and decodes the same through the loader's
    batch call."""
    import hashlib
    import json
    import os

    from dd3d_tpu_torch.data.imageio import decode_resize_batch, read_image_bgr

    for kind in ("png", "jpeg"):
        fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", kind)
        with open(os.path.join(fixtures, "digests.json")) as f:
            digests = json.load(f)
        assert len(digests) >= 35
        for name, want in digests.items():
            img = read_image_bgr(os.path.join(fixtures, name))
            assert list(img.shape) == want["shape"], name
            assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name
            with open(os.path.join(fixtures, name), "rb") as f:
                (batched,) = decode_resize_batch([f.read()], [tuple(want["shape"][:2])])
            assert batched.tobytes() == img.tobytes(), name


def test_jpeg_fixtures_and_remat_steps_on_card(card, monkeypatch):
    """The machine with the card cannot encode JPEGs: the committed fixtures
    (tests/data/jpeg) decode to the digests of the JAX package's libjpeg
    decode. Then the small model's train step (FPN 64, 1-conv towers,
    TPU.PALLAS_STEM_DW, bf16, batch 2 at 128x256) under TPU.REMAT "full" and
    "dots_saveable" gives the "none" step's losses, gradients, updated
    parameters and BN running stats bit for bit under deterministic
    algorithms, the dW kernel twice a step."""
    import hashlib
    import json
    import os

    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.imageio import read_image_bgr
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.ops import conv_dw
    from dd3d_tpu_torch.training.synthetic import seed_norm_statistics, synthetic_batch
    from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
    from dd3d_tpu_torch.training.train_step import make_train_step

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
    with open(os.path.join(fixtures, "digests.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        img = read_image_bgr(os.path.join(fixtures, name))
        assert list(img.shape) == want["shape"] and hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], name

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    batch = to_device(synthetic_batch(np.random.RandomState(1), 2, 128, 256, max_gt=8), card)
    steps = {}
    for policy in ("none", "full", "dots_saveable"):
        cfg = get_experiment_cfg("dd3d_kitti_dla34")
        cfg.TPU.PALLAS_STEM_DW = True
        cfg.TPU.REMAT = policy
        cfg.FE.FPN.OUT_CHANNELS = 64
        cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
        model = seed_norm_statistics(build_model(cfg, generator=torch.Generator().manual_seed(0)),
                                     torch.Generator().manual_seed(1))
        state = create_train_state(cfg, model, card)
        step = make_train_step(cfg, state.model, state.optimizer)
        conv_dw.conv_dw_s1_same.launches = 0
        torch.use_deterministic_algorithms(True)
        try:
            metrics = step(batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        assert conv_dw.conv_dw_s1_same.launches == 2, policy
        steps[policy] = (metrics, {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None},
                         {n: p.detach() for n, p in state.model.named_parameters()}, dict(state.model.named_buffers()))
    for policy in ("full", "dots_saveable"):
        for got, want in zip(steps[policy], steps["none"]):
            assert list(got) == list(want), policy
            for name in want:
                assert torch.equal(got[name], want[name]), f"{policy}: {name}"


# DLA's stem convs through csrc/stem_conv.cu: (name, kernel size, stride, C, O)
STEM_CONVS = (("base_layer", 7, 1, 3, 16), ("level0", 3, 1, 16, 16), ("level1", 3, 2, 16, 32))
KITTI_MEAN, KITTI_STD = (103.530, 116.280, 123.675), (57.375, 57.120, 58.395)


def _stem_case(card, conv, b, h, w, seed):
    """(x, weight, bias, stride) of one stem conv: uint8 frames as
    NormalizedFrames (KITTI's mean and std) for base_layer, a bf16 NCHW
    channels_last tensor for the others; He-scaled bf16 weights, bias
    N(0, 0.3)."""
    from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames

    _, k, stride, c, o = conv
    gen = torch.Generator().manual_seed(seed)
    if c == 3:
        frames = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(card)
        x = NormalizedFrames(frames, torch.tensor(KITTI_MEAN, device=card).view(1, 3, 1, 1),
                             torch.tensor(KITTI_STD, device=card).view(1, 3, 1, 1), torch.bfloat16)
    else:
        x = torch.randn(b, h, w, c, generator=gen).to(card, torch.bfloat16).permute(0, 3, 1, 2)
    weight = (torch.randn(o, c, k, k, generator=gen) * (2.0 / (c * k * k)) ** 0.5).to(card, torch.bfloat16)
    bias = (torch.randn(o, generator=gen) * 0.3).to(card, torch.bfloat16)
    return x, weight, bias, stride


@pytest.mark.parametrize("conv", STEM_CONVS, ids=[c[0] for c in STEM_CONVS])
@pytest.mark.parametrize("b,h,w", [(2, 375, 1242), (2, 384, 1280), (1, 896, 1664), (3, 7, 11), (1, 9, 130)])
def test_stem_conv_kernel_matches_plain(card, conv, b, h, w):
    """The kernel against `stem_conv_plain`: within one bf16 ulp for each
    of the epilogue's two roundings, at the larger of the values rounded,
    beyond the f32 sums' own order error (bench_stem.stem_conv_error: the
    sums are taken in another order, as cuDNN's are), and equal bit for bit
    at all but 1e-3 of the outputs, at KITTI's canvases, the nuScenes one
    and ragged tiles; NHWC out, channels_last strides."""
    from dd3d_tpu_torch.bench_stem import stem_conv_error
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    x, weight, bias, stride = _stem_case(card, conv, b, h, w, seed=h + w)
    stem_conv.launches = 0
    got = stem_conv(x, weight, bias, stride)
    torch.cuda.synchronize()
    assert stem_conv.launches == 1
    assert got.shape == (b, conv[4], (h - 1) // stride + 1, (w - 1) // stride + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = stem_conv_error(got, x, weight, bias, stride)
    assert err["beyond"] == 0 and err["max_ulps"] <= 2.0 and err["equal_share"] >= 0.999, err


def test_stem_conv_normalizes_as_preprocess_image_bit_for_bit(card):
    """Through a centre-tap identity (outputs 0-2 +1, outputs 3-5 -1 on
    channel c, bias 0) relu(n) - relu(-n) is the kernel's normalized frame
    n, which must equal DD3D.preprocess_image's, every uint8 value on every
    channel included. Then a corner tap: rows and columns the tap reads
    outside the image give exactly 0, the normalized domain's zero (a
    normalized uint8 0 would be -mean/std)."""
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    x, _, _, _ = _stem_case(card, STEM_CONVS[0], 2, 40, 300, seed=5)
    x.frames[0, 5, :256] = torch.arange(256, dtype=torch.uint8, device=card)[:, None]
    bias = torch.zeros(16, dtype=torch.bfloat16, device=card)
    for r, s in ((3, 3), (0, 0)):
        weight = torch.zeros(16, 3, 7, 7, dtype=torch.bfloat16, device=card)
        for c in range(3):
            weight[c, c, r, s], weight[3 + c, c, r, s] = 1, -1
        got = stem_conv(x, weight, bias, 1)
        n = (got[:, :3] - got[:, 3:6]).float()
        want = x.normalized().float()
        if (r, s) == (3, 3):
            assert torch.equal(n, want)
        else:  # output (i, j) reads input (i - 3, j - 3)
            assert torch.equal(n[:, :, 3:, 3:], want[:, :, :-3, :-3])
            assert not n[:, :, :3].any() and not n[:, :, :, :3].any()
        assert not got[:, 6:].any()


def test_stem_conv_on_runs_of_images_past_two_to_the_31(card):
    """level0 on 70 images of 1024x1920x16, 2.2e9 elements a tensor: two
    launches of 35 images, and the images at the run boundary and the ends
    equal to a launch of their own."""
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    torch.cuda.empty_cache()
    _, weight, bias, _ = _stem_case(card, STEM_CONVS[1], 1, 8, 8, seed=3)
    x = torch.empty(70, 1024, 1920, 16, dtype=torch.bfloat16, device=card)
    x.normal_(generator=torch.Generator(device=card).manual_seed(4))
    x = x.permute(0, 3, 1, 2)
    stem_conv.launches = 0
    got = stem_conv(x, weight, bias, 1)
    assert stem_conv.launches == 2
    for i in (0, 34, 35, 69):
        assert torch.equal(got[i:i + 1], stem_conv(x[i:i + 1], weight, bias, 1)), i
    del x, got
    torch.cuda.empty_cache()


def _stem_model(card, dtype="bfloat16"):
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.training.synthetic import seed_norm_statistics

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = seed_norm_statistics(build_model(cfg, generator=torch.Generator().manual_seed(0)),
                                 torch.Generator().manual_seed(1))
    return cfg, model.to(card)


def test_stem_conv_launches_on_the_serving_path_and_nowhere_else(card):
    """A bf16 DLA-34 serving forward launches the stem kernel 3 times; f32,
    train mode, calibration capture and static int8 with every stem conv
    quantized (QUANT_MIN_CH 3) launch it 0 times; QUANT_MIN_CH 16 leaves
    base_layer alone in bf16, so 1."""
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (2, 128, 256, 3), dtype=np.uint8)).to(card)
    k = torch.from_numpy(KITTI_K).to(card).expand(2, 3, 3).contiguous()
    cfg, model = _stem_model(card)
    for case, run in (("bf16 serving", lambda: get_inference_fn(model, cfg)(images, k)),
                      ("train mode", lambda: model.train()(images))):
        stem_conv.launches = 0
        run()
        torch.cuda.synchronize()
        assert stem_conv.launches == (3 if case == "bf16 serving" else 0), case
    model.eval()
    stem_conv.launches = 0
    cfg8 = prepare_static_scales(cfg, model, [images], tag="stem_test")  # calibration captures
    assert stem_conv.launches == 0
    for min_ch, want in ((3, 0), (16, 1), (32, 3)):
        cfg8.TPU.QUANT_MIN_CH = min_ch
        stem_conv.launches = 0
        get_inference_fn(model, cfg8)(images, k)
        assert stem_conv.launches == want, min_ch
    cfg32, model32 = _stem_model(card, "float32")
    stem_conv.launches = 0
    get_inference_fn(model32, cfg32)(images, k)
    assert stem_conv.launches == 0


def test_stem_conv_served_batch_against_the_cudnn_path(card, monkeypatch):
    """A served bf16 batch at 384x1280 with the stem kernel, and the same
    model with the rule turned off (cuDNN, bias add, ReLU), each against the
    model's f32 forward (TF32 off): every head output and the detections'
    sorted scores stray from f32 by no more than the bf16 cell's det_ratio
    limit (2.2, benchmark/limits) times what the cuDNN path strays. The
    stem's outputs differ from cuDNN's by bf16 rounding, which the ~40
    layers after it carry on as they carry their own."""
    from dd3d_tpu_torch.models import layers
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.ops.stem_conv import stem_conv

    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randint(0, 256, (4, 384, 1280, 3), dtype=np.uint8)).to(card)
    k = torch.from_numpy(KITTI_K).to(card).expand(4, 3, 3).contiguous()

    def served(cfg, model):
        with torch.inference_mode():
            heads = model(images)
        det = get_inference_fn(model, cfg)(images, k)
        return heads, {key: det[key].float().sort(dim=1, descending=True)[0] for key in ("scores", "scores_3d")}

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref_heads, ref_det = served(*_stem_model(card, "float32"))
    cfg, model = _stem_model(card)
    stem_conv.launches = 0
    heads, det = served(cfg, model)
    assert stem_conv.launches == 6
    monkeypatch.setattr(layers, "stem_conv_engages", lambda **kw: False)
    heads_c, det_c = served(cfg, model)
    assert stem_conv.launches == 6

    def worst(a, b):
        return float((a.float() - b.float()).abs().max()) + 1e-6

    for key in ref_heads:
        for lvl, ref in enumerate(ref_heads[key]):
            ratio = worst(heads[key][lvl], ref) / worst(heads_c[key][lvl], ref)
            assert ratio <= 2.2, (key, lvl, ratio)
    for key in ref_det:
        assert worst(det[key], ref_det[key]) / worst(det_c[key], ref_det[key]) <= 2.2, key
