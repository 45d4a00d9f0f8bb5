"""One run of a cell: the cell's mode (`harness/<mode>.py`, named by the
traffic file) measures and checks; this module reads the metrics the cell
reports and assembles the result line and the checks."""
import importlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from harness.trace import Trace


@dataclass
class Context:
    """What a per-layer metric's reader may read: the window's counts, the
    benchmark's spans (seconds each), the program's counter deltas, the
    device trace, and the conv sites of one forward at the cell's shapes."""
    cell: object
    seconds: float
    batches: int
    images: int
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    trace: Optional[Trace] = None
    _sites: Optional[list] = None

    def sites(self) -> list:
        if self._sites is None:
            from reference.plain import conv_sites

            t = self.cell.traffic
            self._sites = conv_sites(self.cell.config["model"], int(t["batch"]), *t["canvas"])
        return self._sites


@dataclass
class Outcome:
    values: Dict[str, float]  # end-to-end metrics by name
    context: Context
    readings: Dict[str, float]  # the comparison's numbers
    attempted: int
    failed: int
    memory_peak_bytes: int


def device_info(chips: int, device) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run(cell, seed: int, seconds: float, trace: bool, device, start: float, fault=None):
    """(result line as a dict, check lines for standard error)."""
    mode = importlib.import_module(f"harness.{cell.traffic['mode']}")
    out: Outcome = mode.run(cell, seed, seconds, trace, device, start, fault)
    checks = {k: {"value": out.readings[k], "limit": cell.limits[k]} for k in cell.limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = m.reader(out.context)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            metrics[m.name] = {"value": out.values[m.name], "unit": m.unit}
    dev = device_info(cell.chips, device)
    dev["memory_peak_bytes"] = out.memory_peak_bytes
    result = {"correct": bool(ok and out.failed == 0), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.context.trace.busy_s
        dev["window_s"] = out.context.trace.window_s
        result["breakdown"] = out.context.trace.breakdown()
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}"
             for k, c in checks.items()]
    lines.append(f"correct {result['correct']} over {out.readings.get('images', 0)} images")
    return result, lines
