"""What a cell is, read from data: BENCHMARK.json at the checkout's root,
the configuration file it names, the traffic file `traffic/<traffic>.json`,
the limits file `limits/<cell>.json` and a reader module
`metrics/<metric>.py` for each per-layer metric, which declares the
program counters it reads (`COUNTERS`, {name: "module:function"}). A new
cell, configuration, traffic mix or per-layer metric is new files and new
entries; no file here names one."""
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    bound: float = 0.0
    reader: Callable = None
    counters: Dict[str, str] = field(default_factory=dict)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    def counters(self) -> Dict[str, str]:
        """The program counters the cell's per-layer metrics read."""
        return {k: v for m in self.per_layer for k, v in m.counters.items()}


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module `metrics/<name>.py`, loaded by its path (a metric's name
    may hold dots): its `read(ctx)` and its `COUNTERS`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_config(name: str, root: str = ROOT) -> dict:
    """The configuration `name`, from the file BENCHMARK.json gives it."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    files = {c["name"]: c["file"] for c in bench["configs"]}
    return _read_json(os.path.join(root, files[name]))


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    config = load_config(w["config"], root)
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = _read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [Metric(m["name"], m["unit"], m["better"], m["source"], bound=m["bound"])
           for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m.name for m in e2e}
    per_layer = []
    for m in bench["per_layer"]:
        if _applies(m, name) and m["moves"] in reported:
            module = load_reader(m["name"], bench_dir)
            per_layer.append(Metric(m["name"], m["unit"], m["better"], m["source"], layer=m["layer"],
                                    moves=m["moves"], reader=module.read, counters=getattr(module, "COUNTERS", {})))
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config, traffic, limits, e2e, per_layer)
