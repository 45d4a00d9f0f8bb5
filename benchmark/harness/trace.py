"""The device trace of a window: `torch.profiler` with CPU and CUDA
activity around it, reduced in memory to what the readers need. Nothing is
written to disk.

- `busy_s`: the union of the intervals in which a device operation
  (kernel, copy or set) ran, so overlapping streams count once;
- `kernels`: (name, device seconds, launches) of every kernel name;
- `launches`: the kernel launches of the window (copies and sets apart);
- `idle_by_host`: the device's idle time, each gap charged to the
  innermost host operation or span under way at its middle.
The window is the host annotation `bench.window` around the body, in the
profiler's own clock.
"""
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    launches: int = 0
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, predicate) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name passes."""
        sel = [v for k, v in self.kernels.items() if predicate(k)]
        return sum(s for s, _ in sel), sum(n for _, n in sel)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, s) for k, (s, _) in self.kernels.items()), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, s] for k, s in ops], "idle_gaps": [[k, s] for k, s in gaps]}


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals: List[Tuple[float, float]], start: float, stop: float) -> List[Tuple[float, float]]:
    """The gaps in [start, stop] that no interval covers."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, stop)))
        cursor = max(cursor, e)
        if cursor >= stop:
            break
    if cursor < stop:
        gaps.append((cursor, stop))
    return [(a, b) for a, b in gaps if b > a]


def charge_gaps(gaps, host_ops) -> Dict[str, float]:
    """{host op name: idle seconds}: each gap to the innermost host op
    under way at its middle ("no host op" where none is). `host_ops` are
    (start, end, name), in the gaps' unit (microseconds). One sweep: host
    ops of one thread nest, so the innermost open op is the stack's top."""
    ops = sorted(host_ops, key=lambda o: (o[0], -o[1]))
    out: Dict[str, float] = {}
    stack, i = [], 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        key = stack[-1][2] if stack else "no host op"
        out[key] = out.get(key, 0.0) + (b - a) * 1e-6
    return out


WINDOW = "bench.window"


def _events(prof):
    """(device events [(start_us, end_us, name, is_kernel)], host events
    [(start_us, end_us, name)]) from the profiler's own records. The
    device-side copies of host annotations are no device work."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation() or name.startswith("bench."):
                continue
            low = name.lower()
            device.append((start, end, name, not (low.startswith("memcpy") or low.startswith("memset"))))
        else:
            host.append((start, end, name))
    return device, host


@contextlib.contextmanager
def traced(enabled: bool, result: Trace):
    """Profile the body with CPU and CUDA activity when `enabled`, then
    fill `result`; otherwise run it as it is."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            yield
            result.window_s = time.perf_counter() - t0
    device, host = _events(prof)
    window = [(s, e) for s, e, n in host if n == WINDOW]
    if not device or not window:
        raise RuntimeError("the profiler recorded no device activity in the window")
    lo, hi = window[0]
    spans = [(max(s, lo), min(e, hi)) for s, e, _, _ in device if e > lo and s < hi]
    result.busy_s = union_seconds(spans) * 1e-6
    kernels: Dict[str, Tuple[float, int]] = {}
    for s, e, name, is_kernel in device:
        if e <= lo or s >= hi:
            continue
        sec, n = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (min(e, hi) - max(s, lo)) * 1e-6, n + 1)
        result.launches += int(is_kernel)
    result.kernels = kernels
    host_in = [(s, e, n) for s, e, n in host if e >= lo and s <= hi and n != WINDOW]
    result.idle_by_host = charge_gaps(idle_gaps(spans, lo, hi), host_in)
