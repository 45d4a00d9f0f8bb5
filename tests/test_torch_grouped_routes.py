"""The grouped int8 conv's choice of kernel and its CPU path
(dd3d_tpu_torch/ops/int8_conv.py). The choice is Python: every grouped conv
of dd3d_kitti_regnety_006_bifpn goes to the kernel built for its shape (the
Y-block `b` convs to `mma`, BiFPN's `dw` convs to `depthwise`), every
BottleneckX 3x3 of the DLA-X variants at C/g = 2, 4 and 8 to `narrow`, every
other shape to `direct`, and a CPU tensor runs the plain version whatever
route is named. The kernels are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 31)."""
from collections import Counter

import numpy as np
import pytest
import torch

from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.models import build_model
from dd3d_tpu_torch.models.layers import FoldableConv
from dd3d_tpu_torch.ops.int8_conv import (GROUPED_ROUTES, grouped_route, grouped_routes, int8_conv_grouped,
                                          int8_conv_grouped_acc_plain, int8_conv_grouped_plain)

# (H, W, C, groups, stride) of every distinct grouped conv of the regnety
# forward at 384x1280 (O = C), and the route each must take
REGNETY_GROUPED = [
    ((192, 640, 48, 3, 2), "mma"),     # s1_b0/b
    ((96, 320, 112, 7, 2), "mma"),     # s2_b0/b
    ((48, 160, 112, 7, 1), "mma"),     # s2_b1..2/b
    ((48, 160, 256, 16, 2), "mma"),    # s3_b0/b
    ((24, 80, 256, 16, 1), "mma"),     # s3_b1..6/b
    ((24, 80, 608, 38, 2), "mma"),     # s4_b0/b
    ((12, 40, 608, 38, 1), "mma"),     # s4_b1..3/b
    ((48, 160, 160, 160, 1), "depthwise"),  # P3 dw
    ((24, 80, 160, 160, 1), "depthwise"),   # P4 dw
    ((12, 40, 160, 160, 1), "depthwise"),   # P5 dw
    ((6, 20, 160, 160, 1), "depthwise"),    # P6 dw
    ((3, 10, 160, 160, 1), "depthwise"),    # P7 dw
]

# (C, stride, groups) of every grouped conv of the five DLA-X variants at
# C/g = 2, 4 or 8 (O = C): BottleneckX's 3x3, cardinality 32 or 64, stride 2
# in each level's first block
DLAX_NARROW = [
    (64, 2, 32), (64, 1, 32),    # DLA-X-46-C / -60-C levels 2-3: C/g = 2
    (128, 2, 32), (128, 1, 32),  # DLA-X-60 / -102 level 2, the -C variants' level 4: C/g = 4
    (256, 2, 32), (256, 1, 32),  # DLA-X-60 / -102 level 3, the -C variants' level 5: C/g = 8
    (256, 2, 64), (256, 1, 64),  # DLA-X-102-64 level 2: C/g = 4
    (512, 2, 64), (512, 1, 64),  # DLA-X-102-64 level 3: C/g = 8
]

# (C, O, k, stride, groups): shapes no tiled kernel takes
DIRECT_ONLY = [
    (24, 24, 3, 2, 6),     # C/g = 4, C % 16 != 0
    (24, 24, 3, 1, 6),     # the same at stride 1
    (40, 40, 3, 1, 10),    # C/g = 4, C % 16 == 8
    (48, 96, 3, 1, 12),    # C/g = 4, O/g = 8
    (64, 64, 5, 1, 16),    # C/g = 4, 5x5
    (64, 64, 3, 3, 8),     # C/g = 8, stride 3
    (64, 64, 1, 1, 32),    # C/g = 2, 1x1
    (12, 12, 3, 1, 4),     # C/g = 3
    (8, 16, 3, 1, 2),      # O = 2 C
    (160, 320, 3, 1, 160),  # a depthwise multiplier of 2
    (40, 40, 3, 1, 40),    # depthwise, C % 16 != 0
    (64, 64, 5, 1, 4),     # 5x5
    (64, 64, 3, 3, 4),     # stride 3
    (256, 256, 3, 1, 4),   # C/g = 64
    (64, 288, 3, 1, 4),    # O/g = 72, past the mma route's 64
    (64, 260, 3, 1, 4),    # O/g = 65
    (96, 96, 3, 1, 2),     # C/g = 48
]


@pytest.mark.parametrize("shape,route", REGNETY_GROUPED, ids=[f"{s[2]}g{s[3]}s{s[4]}_{s[0]}x{s[1]}"
                                                             for s, _ in REGNETY_GROUPED])
def test_regnety_grouped_shapes_take_their_kernel(shape, route):
    _, _, c, g, stride = shape
    assert grouped_route(c, c, 3, 3, stride, g) == route
    assert grouped_routes(c, c, 3, 3, stride, g) == (route, "direct")


@pytest.mark.parametrize("c,stride,g", DLAX_NARROW)
def test_dlax_narrow_shapes_take_the_narrow_kernel(c, stride, g):
    """Every BottleneckX 3x3 at C/g = 2, 4 or 8 goes to `narrow`, with
    `direct` the only other route that takes it."""
    assert grouped_route(c, c, 3, 3, stride, g) == "narrow"
    assert grouped_routes(c, c, 3, 3, stride, g) == ("narrow", "direct")


@pytest.mark.parametrize("c,o,k,stride,g", DIRECT_ONLY)
def test_other_shapes_take_the_direct_kernel(c, o, k, stride, g):
    assert grouped_routes(c, o, k, k, stride, g) == ("direct",)


def test_every_grouped_conv_of_the_regnety_model_takes_its_kernel():
    """The port's own model at full width: its 15 Y-block `b` convs go to
    `mma` and its 24 BiFPN `dw` convs to `depthwise`, one call each a
    forward."""
    model = build_model(get_experiment_cfg("dd3d_kitti_regnety_006_bifpn"))
    routes = Counter()
    for name, m in model.named_modules():
        if isinstance(m, FoldableConv) and m.groups > 1:
            o, cg, kh, kw = m.weight.shape
            route = grouped_route(cg * m.groups, o, kh, kw, m.stride, m.groups)
            assert route == ("depthwise" if name.endswith(".dw") else "mma"), name
            routes[route] += 1
    assert routes == {"mma": 15, "depthwise": 24}


def _case(b, h, w, c, o, g, seed=0):
    rng = np.random.RandomState(seed)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (o, 3, 3, c // g)).astype(np.int8))
    scale = torch.from_numpy((rng.rand(o) * 1e-3 + 1e-5).astype(np.float32))
    bias = torch.from_numpy(rng.randn(o).astype(np.float32))
    return xq, wq, scale, bias


@pytest.mark.parametrize("c,o,g,stride", [(32, 32, 32, 1), (32, 32, 2, 2), (12, 12, 4, 1), (32, 32, 8, 2),
                                          (32, 32, 16, 1), (16, 16, 2, 1)])
def test_cpu_tensors_run_the_plain_version_on_every_route(c, o, g, stride):
    """On CPU tensors the wrapper runs `int8_conv_grouped_plain`, whichever
    route the shape admits is named, and launches nothing."""
    xq, wq, scale, bias = _case(2, 7, 11, c, o, g)
    want = int8_conv_grouped_plain(xq, wq, scale, bias, stride, 1, torch.bfloat16, g)
    launches, by_route = int8_conv_grouped.launches, dict(int8_conv_grouped.launches_by_route)
    for route in (None, *grouped_routes(c, o, 3, 3, stride, g)):
        assert torch.equal(int8_conv_grouped(xq, wq, scale, bias, stride, 1, torch.bfloat16, g, route=route), want)
    assert int8_conv_grouped.launches == launches
    assert int8_conv_grouped.launches_by_route == by_route
    assert set(by_route) == set(GROUPED_ROUTES)


@pytest.mark.parametrize("c,o,g,route", [(12, 12, 4, "mma"), (12, 12, 4, "depthwise"), (32, 32, 2, "depthwise"),
                                          (32, 32, 32, "mma"), (32, 32, 32, "wgmma"), (12, 12, 4, "narrow"),
                                          (24, 24, 6, "narrow"), (32, 32, 32, "narrow"), (32, 32, 2, "narrow")])
def test_a_route_the_shape_does_not_take_raises(c, o, g, route):
    xq, wq, scale, _ = _case(1, 5, 5, c, o, g)
    with pytest.raises(ValueError, match="route"):
        int8_conv_grouped(xq, wq, scale, None, 1, 1, torch.float32, g, route=route)


@pytest.mark.parametrize("c,g,stride", [(64, 32, 1), (128, 32, 2), (256, 32, 1), (256, 64, 2)])
def test_block_diagonal_weights_give_the_same_grouped_conv(c, g, stride):
    """bench_grouped's tensor-core alternative to `narrow`: the conv of C/g
    = 2, 4 or 8 written as C/32 groups of 32 channels with block-diagonal
    weights has the same int32 sums."""
    from dd3d_tpu_torch.bench_grouped import block_diagonal_weights

    xq, wq, _, _ = _case(2, 6, 9, c, c, g, seed=c + g)
    want = int8_conv_grouped_acc_plain(xq, wq, stride, 1, g)
    assert torch.equal(int8_conv_grouped_acc_plain(xq, block_diagonal_weights(wq, g), stride, 1, c // 32), want)
