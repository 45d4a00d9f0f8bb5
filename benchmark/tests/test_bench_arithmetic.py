"""The arithmetic the metrics and the comparison are made of, on synthetic
inputs: the device's busy and idle time as a union of intervals, the idle
gaps charged to the host, the roofline and mfu counts from layer shapes,
the program counters a reader declares, and the kept-set comparison's firm
decisions."""
import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

import numpy as np

from harness import spec, trace
from reference import bounds, compare, decode


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"t_{name.replace('.', '_')}", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_union_of_overlapping_intervals_counts_once():
    assert trace.union_seconds([(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]) == 26
    assert trace.union_seconds([]) == 0


def test_idle_gaps_and_their_charge_to_the_host():
    busy = [(10, 20), (15, 30), (50, 60)]
    gaps = trace.idle_gaps(busy, 0, 100)
    assert gaps == [(0, 10), (30, 50), (60, 100)]
    assert sum(b - a for a, b in gaps) + trace.union_seconds(busy) == 100
    host = [(0, 100, "bench.enqueue"), (35, 45, "aten::conv"), (36, 44, "cudaLaunchKernel"), (70, 95, "aten::cpu")]
    charged = trace.charge_gaps(gaps, host)
    assert charged == pytest.approx({"bench.enqueue": 10e-6, "cudaLaunchKernel": 20e-6, "aten::cpu": 40e-6})
    assert trace.charge_gaps([(0, 1)], []) == {"no host op": 1e-6}


def test_busy_and_idle_readers():
    t = trace.Trace(window_s=2.0, busy_s=1.5, launches=300)
    ctx = SimpleNamespace(trace=t, batches=3, seconds=2.0)
    assert reader("device_idle.serve").read(ctx) == pytest.approx(25.0)
    assert reader("launches_per_batch.serve").read(ctx) == 100
    assert reader("device_idle.serve").read(SimpleNamespace(trace=None)) is None


def test_enqueue_and_counter_readers():
    ctx = SimpleNamespace(spans={"enqueue_s": [0.1, 0.3, 0.2]}, counters={"int8_conv.launches": 230,
                                                                           "quantize_int8.launches": 110}, batches=2)
    assert reader("host_enqueue_ms.serve").read(ctx) == pytest.approx(200.0)
    assert reader("int8_launches_per_batch").read(ctx) == 170
    assert reader("int8_launches_per_batch").read(SimpleNamespace(counters={}, batches=2)) is None


def conv_site(x, w, stride=1, pad=1, inp=0):
    return {"name": "c", "x": x, "w": w, "stride": stride, "pad": pad, "groups": 1, "input": inp}


def test_int8_roofline_counts_a_shared_input_once_and_is_a_share_of_device_time():
    m = reader("int8_conv_roofline")
    # two convs read one (8, 256, 48, 160) tensor; one 16-channel conv stays bf16
    a = conv_site((8, 256, 48, 160), (256, 256, 3, 3))
    b = conv_site((8, 256, 48, 160), (20, 256, 3, 3))
    small = conv_site((8, 16, 96, 320), (32, 16, 3, 3), inp=1)
    ops = 2 * 8 * 48 * 160 * (256 + 20) * 256 * 9
    nbytes = 8 * 256 * 48 * 160 + (256 + 20) * 256 * 9 + 8 * 48 * 160 * (256 + 20) + 8 * (256 + 20)
    want = max(ops / bounds.PEAK_OPS_PER_S["int8"], nbytes / bounds.HBM_BYTES_PER_S)
    assert m.forward_bound_s([a, b, small], 32) == pytest.approx(want)
    t = trace.Trace(kernels={"void int8_conv_kernel<128>(...)": (4 * want, 10), "cudnn_fprop": (1.0, 5)})
    cell = SimpleNamespace(config={"static_int8": {"min_ch": 32}}, traffic={"batch": 8, "canvas": [384, 1280]})
    ctx = SimpleNamespace(trace=t, batches=2, cell=cell, sites=lambda: [a, b, small])
    assert m.read(ctx) == pytest.approx(50.0)
    ctx.cell = SimpleNamespace(config={})
    assert m.read(ctx) is None


def test_mfu_counts_each_conv_at_the_peak_of_its_type():
    m = reader("mfu.serve")
    a = conv_site((2, 256, 10, 10), (256, 256, 3, 3))
    small = conv_site((2, 16, 10, 10), (16, 16, 3, 3), inp=1)
    ops_a, ops_s = 2 * 2 * 100 * 256 * 256 * 9, 2 * 2 * 100 * 16 * 16 * 9
    int8 = ops_a / bounds.PEAK_OPS_PER_S["int8"] + ops_s / bounds.PEAK_OPS_PER_S["bf16"]
    bf16 = (ops_a + ops_s) / bounds.PEAK_OPS_PER_S["bf16"]
    assert m.forward_peak_s([a, small], 32) == pytest.approx(int8)
    assert m.forward_peak_s([a, small], None) == pytest.approx(bf16)
    ctx = SimpleNamespace(batches=5, seconds=2.0, cell=SimpleNamespace(config={}), sites=lambda: [a, small])
    assert m.read(ctx) == pytest.approx(100 * 5 * bf16 / 2.0)


def test_conv_sites_of_dla34_from_the_configuration():
    from reference.plain import conv_sites

    cfg = spec.load_cell("kitti_dla34_bf16.serve_b128").config
    sites = conv_sites(cfg["model"], 128, 384, 1280)
    assert len(sites) == 145 and sum(s["x"][1] >= 32 for s in sites) == 142
    ops = sum(bounds.conv_ops(s["x"], s["w"], s["stride"], s["pad"]) for s in sites) / 128
    assert ops == pytest.approx(220.768128e9)
    # the five predictors of the 3D tower read one tensor a level
    shared = {}
    for s in sites:
        shared.setdefault(s["input"], []).append(s["name"])
    assert max(len(v) for v in shared.values()) == 5


def test_a_reader_declares_the_counters_it_reads():
    cell = spec.load_cell("kitti_dla34_int8.serve_b128")
    assert cell.counters() == {"int8_conv.launches": "dd3d_tpu_torch.ops.int8_conv:int8_conv",
                               "quantize_int8.launches": "dd3d_tpu_torch.ops.quantize:quantize_int8"}
    assert spec.load_cell("kitti_dla34_bf16.serve_b128").counters() == {}


DEC = {"NMS_THRESH": 0.75, "POST_NMS_TOPK": 3}


def nms_image(boxes, scores, classes, margins=None):
    box = np.asarray(boxes, np.float32)
    image = {"box": box, "score3d": np.asarray(scores, np.float32), "cls": np.asarray(classes),
             "valid": np.ones(len(box), bool), "level": np.zeros(len(box), np.int64), "loc": np.arange(len(box)),
             "margin": np.asarray(margins if margins is not None else [1.0] * len(box), np.float32)}
    image["iou"] = decode.iou_matrix(torch.as_tensor(box), torch.as_tensor(box)).numpy()
    image["kept"] = decode.greedy_walk(image["iou"], image["valid"], image["cls"], DEC["NMS_THRESH"],
                                       DEC["POST_NMS_TOPK"])
    return image


def test_firm_decisions_leave_out_what_rounding_may_flip():
    # 0 and 1 overlap at IoU 0.9 (1 firmly suppressed), 2 overlaps 0 at IoU 0.74 (too close to call),
    # 3 is another class on 0's box (kept: classes do not suppress each other), 4 is alone, and cut
    boxes = [[0, 0, 100, 100], [0, 0, 100, 90], [0, 0, 100, 74], [0, 0, 100, 100], [500, 500, 600, 600]]
    image = nms_image(boxes, [0.9, 0.8, 0.7, 0.6, 0.5], [0, 0, 0, 1, 0])
    assert image["kept"].tolist() == [True, False, True, True, False]  # POST_NMS_TOPK 3 cuts 4
    firm_kept, firm_suppressed = compare.firm(image, DEC, 0.02, 0.03)
    assert firm_kept.tolist() == [True, False, False, True, False]  # 2 is near the threshold
    assert firm_suppressed.tolist() == [False, True, False, False, False]
    # a selection margin under the score margin is no firm decision
    image["margin"][3] = 0.01
    assert compare.firm(image, DEC, 0.02, 0.03)[0].tolist() == [True, False, False, False, False]


def test_kept_set_readings_of_served_detections():
    boxes = [[0, 0, 100, 100], [0, 0, 100, 90], [500, 500, 600, 600]]
    image = nms_image(boxes, [0.9, 0.8, 0.7], [0, 0, 0])
    # one level of three locations: the reference fields at each
    lv = {"box": torch.tensor([boxes], dtype=torch.float32), "score3d": torch.tensor([[[0.9], [0.8], [0.7]]]),
          "depth": torch.ones(1, 3, 1)}

    def served(idx):
        return {"box": np.asarray(boxes, np.float32)[idx], "score3d": np.asarray([0.9, 0.8, 0.7], np.float32)[idx],
                "cls": np.zeros(len(idx), np.int64), "level": np.zeros(len(idx), np.int64),
                "depth": np.ones(len(idx), np.float32)}

    sound = compare.summarize([compare.image_gaps(served([0, 2]), [lv], 0, image, DEC,
                                                  {"score_margin": 0.02, "iou_margin": 0.03}, "cpu")])
    assert (sound["kept_missed"], sound["suppressed_served"], sound["count_gap"]) == (0.0, 0.0, 0.0)
    assert sound["nms_overlap"] == 0.0 and sound["nms_overlap_gap"] == 0.0
    skipped = compare.summarize([compare.image_gaps(served([0, 1, 2]), [lv], 0, image, DEC,
                                                    {"score_margin": 0.02, "iou_margin": 0.03}, "cpu")])
    assert skipped["suppressed_served"] == 1.0 and skipped["count_gap"] == 0.5
    assert skipped["nms_overlap"] == pytest.approx(0.9) and skipped["nms_overlap_gap"] == pytest.approx(0.9)
    lost = compare.summarize([compare.image_gaps(served([0]), [lv], 0, image, DEC,
                                                 {"score_margin": 0.02, "iou_margin": 0.03}, "cpu")])
    assert lost["kept_missed"] == 0.5
    # a share is over at least the stated number of decisions an image
    assert compare.summarize([compare.image_gaps(served([0]), [lv], 0, image, DEC, {"score_margin": 0.02,
                                                 "iou_margin": 0.03}, "cpu")], 10.0)["kept_missed"] == 0.1
