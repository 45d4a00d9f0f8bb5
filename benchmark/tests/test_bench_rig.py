"""The rig cell (`nusc_dla34_bf16.serve_b12`, harness/serve_rig.py): whole
runs on a tiny rig of its own (two six-camera samples a batch on a 128x256
canvas, the program in f32; tiny.py's batch of 2 is no whole sample), sound
and with each fault of harness/faults_rig.py; its control (the
configuration's "control", the reference in a lower precision standing in
for the served detections) not correct where the program on the same seed
is; the readers of its spans, counter and stem kernel on synthetic inputs;
the rig reference importing nothing of the program; and on the card
(`cuda`) the cell's own size: sound and faulted for 2 s, and the control
against the program on three seeds."""
import importlib.util
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from dd3d_tpu_torch.utils import profiling
from dd3d_tpu_torch.utils.profiling import Span
from harness import cellrun, faults_rig, serve_rig, spec, trace

CELL = "nusc_dla34_bf16.serve_b12"
TINY_RIG = {"batch": 12, "min_size_test": 128, "canvas": [128, 256], "pool": 2, "sample_images": 12,
            "warmup_batches": 1}
SEED = 2 ** 33 + 19  # the sample walk suppresses across cameras here at the tiny size (at 2 ** 33 + 17 one box)
CONTROL_SEEDS = (2 ** 35 + 1, 2 ** 35 + 2, 2 ** 35 + 3)
MS = 1_000_000
PROGRAM = ("dd3d_tpu_torch", "dd3d_tpu", "jax", "jaxlib", "flax")


def tiny_rig_cell():
    cell = spec.load_cell(CELL)
    cell.traffic = dict(cell.traffic, **TINY_RIG)
    cell.config = dict(cell.config, dtype="float32")
    return cell


def run(fault=None):
    return cellrun.run(tiny_rig_cell(), SEED, 0.2, False, "cpu", time.perf_counter(), fault=fault)


def control_readings(cell, seed, device, seconds):
    """(readings of the program, readings of the control) over the same
    served samples of one seed's window."""
    s = serve_rig.RigServe(cell, seed, device)
    w = s.window(seconds, False)
    pool, state_dict = s.pool, s.state_dict
    s.release()
    mine = serve_rig.reference_readings(cell, seed, pool, w.served, state_dict, device)
    theirs = serve_rig.reference_readings(cell, seed, pool, w.served, state_dict, device,
                                          control=cell.config["control"])
    return mine, theirs


def correct(cell, readings):
    """harness/cellrun.py's verdict on a run's readings."""
    return all(math.isfinite(readings[k]) and readings[k] <= limit for k, limit in cell.limits.items())


def test_a_sound_run_is_correct_and_prints_the_contract_line():
    result, lines = run()
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    cell = spec.load_cell(CELL)
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits)
    assert lines[-1] == "correct True over 12 images"


@pytest.mark.parametrize("fault", list(faults_rig.FAULTS.values()), ids=list(faults_rig.FAULTS))
def test_each_fault_of_the_rig_is_not_correct(fault):
    result, lines = run(fault)
    assert not result["correct"], result["checks"]
    assert any(line.endswith("FAIL") for line in lines)


def test_the_control_is_not_correct_where_the_program_is():
    cell = tiny_rig_cell()
    mine, theirs = control_readings(cell, SEED, "cpu", 0.2)
    assert correct(cell, mine), mine
    assert not correct(cell, theirs), {k: theirs[k] for k in cell.limits}


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"t_{name.replace('.', '_')}", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def served_batch(rows, t0, bev_ms, aggregate_ms):
    """One `serve` root: the decode with its per-image BEV NMS, then the
    sample aggregation, each with a `bev.iou` and a `bev.scan` inside."""
    root = len(rows)

    def add(name, start, length, parent):
        rows.append(Span(name, start, start + length, parent, root))
        return len(rows) - 1

    end = t0 + (10 + bev_ms + aggregate_ms) * MS
    add("serve", t0, end - t0, -1)
    decode = add("serve.decode", t0, (10 + bev_ms) * MS, root)
    bev = add("decode.bev_nms", t0 + 10 * MS, bev_ms * MS, decode)
    for name in ("bev.iou", "bev.scan"):
        add(name, t0 + 10 * MS, bev_ms * MS / 2, bev)
    aggregate = add("serve.aggregate", t0 + (10 + bev_ms) * MS, aggregate_ms * MS, root)
    add("bev.iou", t0 + (10 + bev_ms) * MS, aggregate_ms * MS / 2, aggregate)
    return end


@pytest.fixture
def table(monkeypatch):
    rows = [Span("decode.bev_nms", 0, 50 * MS, -1, 0)]  # a root of its own, not a served batch: not read
    end = served_batch(rows, 100 * MS, 4, 9)
    end = served_batch(rows, end + MS, 6, 11)
    served_batch(rows, end + MS, 20, 30)
    monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    return rows


@pytest.mark.parametrize("name, want", [("bev_nms_host_ms.serve", 6.0), ("aggregate_host_ms.serve", 11.0)])
def test_span_readers_take_the_median_over_served_batches(table, name, want):
    assert reader(name).read(None) == pytest.approx(want)


@pytest.mark.parametrize("name", ["bev_nms_host_ms.serve", "aggregate_host_ms.serve"])
def test_span_readers_read_nothing_without_their_span(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [Span("serve", 0, MS, -1, 0)])  # a KITTI batch, or the parent
    assert reader(name).read(None) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(None) is None


def test_scan_launches_reader():
    m = reader("bev_scan_launches_per_batch")
    assert m.COUNTERS == {"greedy_nms_scan.launches": "dd3d_tpu_torch.ops.nms_kernel:greedy_nms_scan"}
    assert m.read(SimpleNamespace(counters={"greedy_nms_scan.launches": 46}, batches=23)) == 2
    assert m.read(SimpleNamespace(counters={}, batches=23)) is None
    assert m.read(SimpleNamespace(counters={"greedy_nms_scan.launches": 0}, batches=23)) is None


def test_the_rig_stem_roofline_reads_the_kernel_at_the_cells_own_shapes():
    from reference.plain import conv_sites

    m, kitti = reader("stem_conv_roofline.rig"), reader("stem_conv_roofline")
    cell = spec.load_cell(CELL)
    assert "stem_conv_roofline.rig" in {x.name for x in cell.per_layer}
    assert "stem_conv_roofline" not in {x.name for x in cell.per_layer}
    sites = conv_sites(cell.config["model"], 12, 896, 1664)
    t = trace.Trace(kernels={"void (anonymous namespace)::stem_conv_kernel<7, 1, 3, 16>(...)": (0.02, 10),
                             "void (anonymous namespace)::stem_conv_kernel<3, 2, 16, 32>(...)": (0.01, 10),
                             "cudnn_fprop": (1.0, 5)})
    ctx = SimpleNamespace(trace=t, batches=10, cell=cell, sites=lambda: sites)
    bound = kitti.stem_bound_s(sites)
    # 12 frames of 896x1664: 3 bytes a pixel in, level1's 32 channels at half the size out at two
    assert bound >= (12 * 896 * 1664 * 3 + 2 * 12 * 32 * 448 * 832) / 3.35e12
    assert m.read(ctx) == pytest.approx(100 * 10 * bound / 0.03)
    ctx.trace = trace.Trace(kernels={"sm80_xmma_fprop_implicit_gemm_bf16bf16": (1.0, 5)})
    assert m.read(ctx) is None
    ctx.trace = None
    assert m.read(ctx) is None


def test_the_rig_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from reference import compare_rig, nusc_dd3d_dla34, rig; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, spec.BENCH_DIR, *PROGRAM], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"


@pytest.mark.cuda
def test_on_the_card_sound_is_correct_and_each_fault_is_not():
    """At the cell's own batch, canvas and precision, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size and precision run only there")
    sound, _ = cellrun.run(spec.load_cell(CELL), SEED + 1, 2.0, False, "cuda", time.perf_counter())
    assert sound["correct"], sound["checks"]
    for name, fault in faults_rig.FAULTS.items():
        result, _ = cellrun.run(spec.load_cell(CELL), SEED + 1, 2.0, False, "cuda", time.perf_counter(), fault=fault)
        print(name, {k: c["value"] for k, c in result["checks"].items()})
        assert not result["correct"], (name, result["checks"])


@pytest.mark.cuda
def test_on_the_card_the_control_is_not_correct_where_the_program_is():
    """At the cell's own batch, canvas and precision, three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size and precision run only there")
    cell = spec.load_cell(CELL)
    for seed in CONTROL_SEEDS:
        mine, theirs = control_readings(cell, seed, "cuda", 1.0)
        print("control", seed, {k: (mine[k], theirs[k]) for k in cell.limits})
        assert correct(cell, mine), (seed, mine)
        assert not correct(cell, theirs), (seed, {k: theirs[k] for k in cell.limits})
