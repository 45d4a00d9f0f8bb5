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


@pytest.mark.parametrize("b,n", [(8, 512), (3, 300), (1, 1), (2, 63), (2, 64), (2, 65), (1, 2048)])
def test_kernel_matches_plain(card, b, n):
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    boxes, valid = _random_boxes(np.random.RandomState(2), b, n)
    bt, vt = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    for thr in (0.5, 0.75):
        before = greedy_nms.launches
        keep = greedy_nms(bt, vt, thr)
        assert greedy_nms.launches == before + 1
        assert torch.equal(keep, greedy_nms_plain(bt, vt, thr))


@pytest.mark.parametrize("n", [1, 65, 300, 2048])
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
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    with pytest.raises(ValueError, match="maximum"):
        greedy_nms(torch.zeros(1, 4096, 4, device=card), torch.ones(1, 4096, dtype=torch.bool, device=card), 0.5)


def scan_case(rng, b, n):
    """A score-sorted suppression matrix as the rotated BEV NMS hands it to
    the scan: most pairs far below 0.5, some above, a lattice of pairs at
    exactly 0.5 (not suppressed: the test is strict), and invalid boxes."""
    iou = (rng.rand(b, n, n) ** 8).astype(np.float32)
    iou[:, ::7, ::5] = 0.5
    return iou, rng.rand(b, n) > 0.1


@pytest.mark.parametrize("b,n", [(12, 100), (2, 600), (1, 2048), (3, 65), (1, 1)])
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

    with pytest.raises(ValueError, match="maximum"):
        greedy_nms_scan(torch.zeros(1, 4096, 4096, device=card), torch.ones(1, 4096, dtype=torch.bool, device=card),
                        0.5)
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
