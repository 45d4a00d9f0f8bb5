"""Profiling harness, counterpart of dd3d_tpu/utils/profiling.py over
torch.profiler and CUDA synchronisation in place of jax.profiler:

- `trace(logdir)`: a context that records the host's and the card's
  activity and writes a Chrome/Perfetto trace (`trace.json`) into `logdir`;
- `annotate(name)`: a labelled range inside such a trace
  (torch.profiler.record_function);
- `timed(fn, *args)`: (seconds a call, the last output), with the card
  synchronised before the clock starts and after the last call
  (`torch.cuda.synchronize` on the device of the output's first tensor;
  none for CPU tensors), since PyTorch returns before the card finishes.
"""
import contextlib
import os
import time
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return record_function(name)


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
