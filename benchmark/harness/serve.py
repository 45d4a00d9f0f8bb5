"""The serving mode: a closed loop of one client, batches back to back from
the traffic's pool, each a request of host frames in and host detections
out through the program's serving entry; then the check of a seeded sample
of what the window served against the plain reference.
"""
import contextlib
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from harness import program, traffic as traffic_gen
from harness.trace import Trace, traced
from reference import compare, decode, plain, weights


@dataclass
class Window:
    seconds: float = 0.0
    batches: int = 0
    images: int = 0
    enqueue_s: List[float] = field(default_factory=list)  # call to return of the serving entry
    served: List[tuple] = field(default_factory=list)  # (pool index, host detections)
    counters: Dict[str, int] = field(default_factory=dict)
    trace: Trace = field(default_factory=Trace)


class Serve:
    """Set-up of a serving cell: inputs and weights from the seed, then the
    program's server. `fault`, for the harness's own tests, wraps the
    serving entry."""

    def __init__(self, cell, seed: int, device, fault=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.pool = traffic_gen.serve_pool(cell.traffic, seed, device)
        self.state_dict = weights.make_state_dict(plain.build(cell.config["model"], device).state_dict(),
                                                  traffic_gen.derive(seed, "weights"), device)
        calib = [self.pool[i]["images"] for i in range(int(cell.config.get("static_int8", {}).get("batches", 0)))]
        infer = program.build_server(cell.config, self.state_dict, calib, device)
        self.infer = fault(infer) if fault else infer
        for i in range(int(cell.traffic.get("warmup_batches", 2))):
            self.request(self.pool[i % len(self.pool)])
        if device != "cpu":
            torch.cuda.synchronize()

    def request(self, batch: Dict[str, np.ndarray]):
        return self.infer(batch["images"], batch["intrinsics"])

    def window(self, seconds: float, trace: bool) -> Window:
        """Batches back to back until `seconds` have passed; the last batch
        ends the window, so every batch counted is whole."""
        from torch.profiler import record_function

        span = record_function if trace else (lambda name: contextlib.nullcontext())
        w = Window()
        before = program.counters(self.cell.counters())
        with traced(trace, w.trace):
            t0 = time.perf_counter()
            i = 0
            while True:
                p = i % len(self.pool)
                t_call = time.perf_counter()
                with span("bench.enqueue"):
                    det = self.request(self.pool[p])
                t_ret = time.perf_counter()
                with span("bench.to_host"):
                    host = {k: v.cpu().numpy() for k, v in det.items()}
                t_done = time.perf_counter()
                w.enqueue_s.append(t_ret - t_call)
                w.served.append((p, host))
                i += 1
                if t_done - t0 >= seconds:
                    break
            w.seconds = t_done - t0
        after = program.counters(self.cell.counters())
        w.counters = {k: after[k] - before[k] for k in after}
        w.batches = i
        w.images = i * int(self.cell.traffic["batch"])
        return w

    def release(self):
        """Frees the program's state before the reference runs."""
        self.infer = None
        gc.unfreeze()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def reference_producer(cell, ref, pool, device, how: dict):
    """`produce(frames, intrinsics)` -> per image, the detections of the
    reference computed in a stated precision: {"dtype": "bfloat16"} casts a
    copy of the model and its input; {"bits": n, "min_ch": m,
    "calibration_batches": k} fake-quantizes every conv of at least m input
    channels at n bits, its activation scales calibrated on the first k
    batches of the pool (the program's own calibration frames)."""
    import copy

    dec, strides = cell.config["decode"], list(cell.config["model"]["strides"])
    if "dtype" in how:
        low = copy.deepcopy(ref).to(getattr(torch, how["dtype"]))

        def produce(frames, k):
            with torch.no_grad():
                out = low(frames.permute(0, 3, 1, 2).to(getattr(torch, how["dtype"])))
            return decode.detections(decode.dense_levels(out, k, strides, dec), dec)
        return produce
    bits, min_ch = int(how["bits"]), int(how["min_ch"])
    block = int(cell.traffic.get("reference_block", 8))
    batches = (torch.as_tensor(pool[i]["images"][j:j + block], device=device)
               for i in range(int(how["calibration_batches"])) for j in range(0, int(cell.traffic["batch"]), block))
    amax = plain.calibrate(ref, batches, min_ch)

    def produce(frames, k):
        with plain.quantized(ref, amax, bits, min_ch):
            levels = decode.dense_levels(plain.forward(ref, frames), k, strides, dec)
        return decode.detections(levels, dec)
    return produce


def reference_readings(cell, seed: int, pool, served: List[tuple], state_dict, device, control=None) -> dict:
    """The comparison's numbers over a sample, drawn from the seed, of the
    images the window served, against the reference in f32 (TF32 off); and
    the same numbers of the reference computed in the configuration's own
    precision (its "yardstick") over the same images. The ratios
    (`det_ratio`, `det_mean_ratio`, `depth_ratio`) are the served numbers
    over the yardstick's: how far the program lies from f32 in units of what
    its stated precision itself costs on these frames and weights, which
    swings far less from seed to seed than a gap alone; for the same reason
    `kept_missed_excess` and `suppressed_served_excess` are the served
    shares less the yardstick's (a ratio of shares near 0 would not hold).
    `control`, a `reference_producer` spec, stands the reference in a lower
    precision in for the served detections."""
    n_img = int(cell.traffic["batch"])
    sample = int(cell.traffic["sample_images"])
    rng = np.random.default_rng(traffic_gen.derive(seed, "sample"))
    picks = rng.choice(len(served) * n_img, size=min(sample, len(served) * n_img), replace=False)
    by_batch: Dict[int, List[int]] = {}
    for pick in sorted(int(x) for x in picks):
        by_batch.setdefault(pick // n_img, []).append(pick % n_img)
    plain.strict_f32()
    ref = plain.build(cell.config["model"], device)
    ref.load_state_dict(state_dict)
    yardstick = reference_producer(cell, ref, pool, device, cell.config["yardstick"])
    lower = reference_producer(cell, ref, pool, device, control) if control else None
    dec, margins = cell.config["decode"], cell.config["compare"]
    block = int(cell.traffic.get("reference_block", 8))
    got_gaps, yard_gaps = [], []
    for bi, images in by_batch.items():
        p, det = served[bi]
        for start in range(0, len(images), block):
            idx = images[start:start + block]
            frames = torch.as_tensor(pool[p]["images"][idx], device=device)
            k = torch.as_tensor(pool[p]["intrinsics"][idx], device=device)
            levels = decode.dense_levels(plain.forward(ref, frames), k, cell.config["model"]["strides"], dec)
            decided = decode.nms(decode.candidates(levels, dec), dec)
            got = lower(frames, k) if lower else compare.served_images({key: v[idx] for key, v in det.items()})
            yard = yardstick(frames, k)
            got_gaps += [compare.image_gaps(got[j], levels, j, decided[j], dec, margins, device)
                         for j in range(len(idx))]
            yard_gaps += [compare.image_gaps(yard[j], levels, j, decided[j], dec, margins, device)
                          for j in range(len(idx))]
    readings = compare.summarize(got_gaps, margins["least_decisions"])
    yard = compare.summarize(yard_gaps, margins["least_decisions"])
    for k in compare.PER_IMAGE:
        ratio = k.replace("_gap", "") + "_ratio"
        readings[ratio] = readings[k] / max(yard[k], 1e-12)
    for k in ("kept_missed", "suppressed_served"):
        readings[f"{k}_excess"] = readings[k] - yard[k]
    readings.update({f"yardstick_{k}": v for k, v in yard.items()})
    readings["images"] = len(got_gaps)
    return readings


def run(cell, seed: int, seconds: float, trace: bool, device, start: float, fault=None):
    """Set-up, the window, then the reference check; see harness/cellrun.py."""
    from harness.cellrun import Context, Outcome

    cuda = device != "cpu"
    s = Serve(cell, seed, device, fault)
    gc.collect()
    gc.freeze()  # what set-up made is never scanned again: no full collection of the model in the window
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - start
    w = s.window(seconds, trace)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    pool, state_dict = s.pool, s.state_dict
    s.release()
    readings = reference_readings(cell, seed, pool, w.served, state_dict, device)
    values = {
        "setup_s": setup_s,
        "serve_images_per_s": w.images / w.seconds,
        "peak_mem_gib": window_peak / 2 ** 30,
    }
    ctx = Context(cell, w.trace.window_s if trace else w.seconds, w.batches, w.images,
                  {"enqueue_s": w.enqueue_s}, w.counters, w.trace if trace else None)
    return Outcome(values, ctx, readings, attempted=w.batches, failed=0,
                   memory_peak_bytes=int(max(setup_peak, window_peak)))
