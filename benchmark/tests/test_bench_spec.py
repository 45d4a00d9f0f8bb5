"""BENCHMARK.json against the contract's shape, and the harness finding a
cell's configuration, traffic, limits and metric readers by name alone."""
import json
import os
import re
import shutil

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    reported = {w["name"]: {m["name"] for m in b["end_to_end"] if spec._applies(m, w["name"])} for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", reported):
            assert m["moves"] in reported[cell], (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_load_cell_by_name(cell):
    c = spec.load_cell(cell)
    assert c.traffic["mode"] and c.limits and c.config["name"] == c.config_name
    assert {m.name for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2 and c.per_layer
    assert all(callable(m.reader) for m in c.per_layer)
    assert c.limits and not set(c.limits) - {"det_ratio", "det_mean_ratio", "depth_ratio", "kept_missed_excess",
                                             "suppressed_served_excess", "nms_overlap_gap", "count_gap"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_config.no_such_traffic")


def test_adding_a_cell_a_config_and_a_metric_needs_only_new_files(tmp_path):
    """A later PR's addition, made in a copy: new files and new entries in
    BENCHMARK.json, no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("out", "__pycache__"))
    b = bench()
    base = b["configs"][0]
    with open(os.path.join(spec.ROOT, base["file"])) as f:
        cfg = json.load(f)
    cfg["name"] = "kitti_dla34_new"
    (root / "benchmark" / "configs" / "kitti_dla34_new.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark" / "traffic" / "serve_b128.json").read_text())
    traffic["batch"] = 64
    (root / "benchmark" / "traffic" / "serve_b64.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "limits" / "kitti_dla34_new.serve_b64.json").write_text(json.dumps({"det_ratio": 2.0}))
    (root / "benchmark" / "metrics" / "batches_per_s.serve.py").write_text(
        "def read(ctx):\n    return ctx.batches / ctx.seconds if ctx.seconds else None\n")
    b["configs"].append(dict(base, name="kitti_dla34_new", file="benchmark/configs/kitti_dla34_new.json"))
    b["workloads"].append({"name": "kitti_dla34_new.serve_b64", "config": "kitti_dla34_new", "traffic": "serve_b64",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "batches_per_s.serve", "unit": "batches/s", "better": "higher",
                           "source": "program_span", "layer": "Serving entry", "moves": "serve_images_per_s",
                           "workloads": ["kitti_dla34_new.serve_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("kitti_dla34_new.serve_b64", str(root))
    assert cell.traffic["batch"] == 64 and cell.limits == {"det_ratio": 2.0}
    reader = {m.name: m.reader for m in cell.per_layer}["batches_per_s.serve"]

    class Ctx:
        batches, seconds = 10, 4.0

    assert reader(Ctx()) == 2.5
    assert "batches_per_s.serve" not in {m.name for m in spec.load_cell(b["workloads"][0]["name"], str(root)).per_layer}
