"""The readers of the program's span table (dd3d_tpu_torch/utils/profiling.
spans()) on a synthetic table of two served batches with known durations:
each reads its span's median over the `serve` roots, ignores spans outside
a `serve` root, and reads nothing from an empty table or from a program
that has no span table."""
import importlib.util
import os

import pytest

from dd3d_tpu_torch.utils import profiling
from dd3d_tpu_torch.utils.profiling import Span
from harness import spec

MS, US = 1_000_000, 1_000
READERS = ("to_device_ms.serve", "forward_host_ms.serve", "decode_host_ms.serve", "int8_conv_host_us")


def reader(name):
    path = os.path.join(spec.BENCH_DIR, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"t_{name.replace('.', '_')}", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def served_batch(rows, t0, to_device_ms, forward_ms, decode_ms, conv_us):
    """Appends one `serve` root and its children, each child right after the
    one before; the int8 convs inside `forward.backbone`."""
    root = len(rows)

    def add(name, start, length, parent):
        rows.append(Span(name, start, start + length, parent, root))
        return len(rows) - 1

    end = t0 + (to_device_ms + forward_ms + decode_ms) * MS
    add("serve", t0, end - t0, -1)
    add("serve.to_device", t0, to_device_ms * MS, root)
    t = t0 + to_device_ms * MS
    forward = add("serve.forward", t, forward_ms * MS, root)
    backbone = add("forward.backbone", t, forward_ms * MS, forward)
    for us in conv_us:
        add("int8.conv", t, us * US, backbone)
        t += us * US
    add("serve.decode", t0 + (to_device_ms + forward_ms) * MS, decode_ms * MS, root)
    return end


@pytest.fixture
def table(monkeypatch):
    rows = []
    rows.append(Span("int8.conv", 0, 5 * MS, -1, 0))  # a root of its own, not a served batch: not read
    end = served_batch(rows, 10 * MS, 30, 140, 20, [100, 200, 300])
    served_batch(rows, end + MS, 40, 160, 10, [300, 500])
    monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    return rows


@pytest.mark.parametrize("name, want", [("to_device_ms.serve", 35.0), ("forward_host_ms.serve", 150.0),
                                        ("decode_host_ms.serve", 15.0), ("int8_conv_host_us", 300.0)])
def test_each_reader_takes_the_median_over_served_batches(table, name, want):
    assert reader(name).read(None) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_table_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(None) is None
