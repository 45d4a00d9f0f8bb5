"""Profiling harness, counterpart of dd3d_tpu/utils/profiling.py over
torch.profiler and CUDA synchronisation in place of jax.profiler:

- `trace(logdir)`: a context that records the host's and the card's
  activity and writes a Chrome/Perfetto trace (`trace.json`) into `logdir`;
- `annotate(name)`: a span at a layer boundary. While a profiler records,
  a `record_function` range in its trace and one row of the span table
  (`spans()`), both on the host clock the device's intervals are placed
  on; otherwise it enters nothing beyond one check of the profiler's flag;
- `spans()` / `clear_spans()`: the span table, rows `Span(name, start_ns,
  end_ns, parent, root)`; `trace(logdir)` clears it on entry;
- `timed(fn, *args)`: (seconds a call, the last output), with the card
  synchronised before the clock starts and after the last call
  (`torch.cuda.synchronize` on the device of the output's first tensor;
  none for CPU tensors), since PyTorch returns before the card finishes.
"""
import contextlib
import os
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    """One span: `time.time_ns()` at entry and exit (the profiler's clock);
    `parent` and `root` are the row indices of the enclosing and the
    outermost open span (-1 and its own index for a root). A root is one
    request, e.g. one served batch."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


# The profiler records the thread that started it (and the autograd
# engine's threads), so spans open on one thread at a time.
_SPANS: List[Span] = []
_OPEN: List[Tuple[int, int]] = []  # the open spans' (row, clearing), innermost last
_cleared = 0  # clearings so far: a span open across `clear_spans` leaves no row
_OFF = contextlib.nullcontext()


class _Annotation:
    __slots__ = ("name", "row", "cleared", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        start = time.time_ns()  # the row's interval holds the profiler's range
        self.cleared = _cleared
        outer = _OPEN[-1][0] if _OPEN and _OPEN[-1][1] == _cleared else -1
        self.row = len(_SPANS)
        _SPANS.append(Span(self.name, start, 0, outer, self.row if outer < 0 else _SPANS[outer].root))
        _OPEN.append((self.row, _cleared))
        self.range = record_function(self.name).__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _OPEN.pop()
        if self.cleared == _cleared:
            _SPANS[self.row] = _SPANS[self.row]._replace(end_ns=time.time_ns())


def annotate(name: str):
    """A span named `name` around the body (see the module's docstring). It
    reads the host clock only: no device synchronisation, no CUDA event."""
    return _Annotation(name) if torch.autograd._profiler_enabled() else _OFF


def spans() -> List[Span]:
    """The span table: every span entered while a profiler recorded since
    the last `clear_spans`, in order of entry."""
    return list(_SPANS)


def clear_spans() -> None:
    global _cleared
    _SPANS.clear()
    _cleared += 1


@contextlib.contextmanager
def trace(logdir: str):
    clear_spans()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    values = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _barrier(out) -> None:
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def timed(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> Tuple[float, object]:
    """Returns (seconds_per_call, last_output) on the host's clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _barrier(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _barrier(out)
    return (time.perf_counter() - t0) / iters, out
