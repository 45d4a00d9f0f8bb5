"""The arithmetic of `stem_conv_roofline` (metrics/stem_conv_roofline.py):
DLA-34's stem sites counted as one fused chain, its least time at the
cells' batch and canvas, and the reader's share of the traced
`stem_conv_kernel` device time, None without such launches."""
import importlib.util
import os
from types import SimpleNamespace

import pytest

from harness import spec, trace
from reference import bounds


def reader():
    path = os.path.join(spec.BENCH_DIR, "metrics", "stem_conv_roofline.py")
    s = importlib.util.spec_from_file_location("t_stem_conv_roofline", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_stem_roofline_counts_the_stem_as_one_fused_chain():
    from reference.plain import conv_sites

    m = reader()
    cfg = spec.load_cell("kitti_dla34_bf16.serve_b128").config
    sites = conv_sites(cfg["model"], 128, 384, 1280)
    stem = [s["name"] for s in sites if m.stem_bound_s([s]) > 0]
    assert stem == ["backbone.bottom_up.base_layer", "backbone.bottom_up.level0.0", "backbone.bottom_up.level1.0"]
    # 731 GFLOP at the bf16 peak outlasts the 1.2 GB of frames in and level1's output out
    ops = 128 * 384 * 1280 * 2 * (16 * 3 * 49 + 16 * 16 * 9) + 128 * 192 * 640 * 2 * 32 * 16 * 9
    nbytes = 128 * 384 * 1280 * 3 + 2 * 128 * 32 * 192 * 640
    assert nbytes / bounds.HBM_BYTES_PER_S == pytest.approx(0.35683e-3, rel=1e-4)
    assert m.stem_bound_s(sites) == pytest.approx(ops / bounds.PEAK_OPS_PER_S["bf16"])
    assert m.stem_bound_s(sites) * 1e3 == pytest.approx(0.7389, abs=5e-5)


def test_stem_roofline_reads_the_kernel_launches_and_nothing_else():
    from reference.plain import conv_sites

    m = reader()
    cfg = spec.load_cell("kitti_dla34_int8.serve_b128").config
    sites = conv_sites(cfg["model"], 128, 384, 1280)
    cell = SimpleNamespace(config=cfg, traffic={"batch": 128, "canvas": [384, 1280]})
    t = trace.Trace(kernels={"void (anonymous namespace)::stem_conv_kernel<7, 1, 3, 16>(...)": (0.02, 10),
                             "void (anonymous namespace)::stem_conv_kernel<3, 1, 16, 16>(...)": (0.01, 10),
                             "cudnn_fprop": (1.0, 5)})
    ctx = SimpleNamespace(trace=t, batches=10, cell=cell, sites=lambda: sites)
    assert m.read(ctx) == pytest.approx(100 * 10 * m.stem_bound_s(sites) / 0.03)
    ctx.trace = trace.Trace(kernels={"sm80_xmma_fprop_implicit_gemm_bf16bf16": (1.0, 5)})  # cuDNN's stem
    assert m.read(ctx) is None
    ctx.trace = None
    assert m.read(ctx) is None
