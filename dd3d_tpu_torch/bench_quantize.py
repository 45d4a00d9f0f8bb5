"""Time the standalone int8 quantize kernel on the card against another
checkout's and against a cast that moves the same bytes.

    python -m dd3d_tpu_torch.bench_quantize [--other DIR] [--out FILE]

The shapes are (8, 48, 160, 256) bf16 (a P3 tower-conv input) and those of
every quantize launch that stays standalone in one dd3d_kitti_dla34
static-int8 forward at batch 8, 384x1280 (QUANT_MIN_CH 32, QUANT_UNFOLDED,
the head towers' links fused into the int8 conv; random weights calibrated
on one random batch). At each shape, each arm's device time a call comes
from one profiler window of 20 calls, in turns: other, this, cast, cast,
this, other. `this` is csrc/quantize.cu of this checkout through
`ops.quantize.quantize_int8`; `other` is DIR/dd3d_tpu_torch/csrc/quantize.cu
(for example the parent commit, unpacked with `git archive`), built with
the same nvcc flags and called through its C entry; `cast` is
`x.to(torch.int8)`, 2 bytes in and 1 out an element like the quantize, a
yardstick of the bandwidth a streaming kernel reaches on the card now, not
the same function. Both kernels' codes are checked equal to the plain
version. Each line gives the byte bound (3.35 TB/s). Needs a CUDA card and
nvcc; the summary goes to `--out` as JSON.
"""
import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
P3_SHAPE = (8, 48, 160, 256)


def build_other(root: str, build_dir: str):
    """The C entry dd3d_quantize_int8 of `root`'s csrc/quantize.cu."""
    from dd3d_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    src = os.path.join(root, "dd3d_tpu_torch", "csrc", "quantize.cu")
    lib_path = os.path.join(build_dir, "libquantize_other.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path, src], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.dd3d_quantize_int8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_void_p]
    lib.dd3d_quantize_int8.restype = ctypes.c_int

    def quantize(x, xs):
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        err = lib.dd3d_quantize_int8(x.data_ptr(), int(x.dtype == torch.bfloat16), xs.data_ptr(), q.data_ptr(),
                                     x.numel(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other checkout's quantize kernel failed to launch: error {err}")
        return q

    return quantize


def quantize_shapes(infer, images, intrinsics):
    """{(shape, dtype): launches} of the standalone quantize calls of one
    `infer(images, intrinsics)`, recorded on the name the int8 conv's
    wrapper calls."""
    from dd3d_tpu_torch.ops import int8_conv as int8_ops

    shapes, real = {}, int8_ops.quantize_int8

    def record(x, xs):
        key = (tuple(x.shape), x.dtype)
        shapes[key] = shapes.get(key, 0) + 1
        return real(x, xs)

    int8_ops.quantize_int8 = record
    try:
        infer(images, intrinsics)
    finally:
        int8_ops.quantize_int8 = real
    return shapes


def standalone_shapes(device):
    """`quantize_shapes` of one fused dd3d_kitti_dla34 static-int8 forward
    at batch 8, 384x1280."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.QUANT_INT8, cfg.TPU.QUANT_MIN_CH, cfg.TPU.QUANT_UNFOLDED = True, 32, True
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (8, 384, 1280, 3), dtype=np.uint8))
    images = images.to(device)
    k = torch.tensor([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]], device=device)
    cfg8 = prepare_static_scales(cfg, model, [images], tag="bench_quantize")
    return quantize_shapes(get_inference_fn(model, cfg8), images, k.expand(8, 3, 3))


def device_ms(fn, reps=20):
    """Device time of one call of `fn`: the kernels of one profiler window
    over `reps` calls, after one call outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    return total / 1e3 / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout whose csrc/quantize.cu is timed beside this one's")
    ap.add_argument("--out", help="write the summary here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_quantize: needs a CUDA card")
    from dd3d_tpu_torch.ops.quantize import quantize_int8, quantize_int8_plain

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as build_dir:
        arms = {"this": quantize_int8, "cast": lambda x, xs: x.to(torch.int8)}
        if args.other:
            arms["other"] = build_other(args.other, build_dir)
        order = [a for a in ("other", "this", "cast", "cast", "this", "other") if a in arms]
        shapes = standalone_shapes(device)
        cases = [("P3 tower input", P3_SHAPE, torch.bfloat16, 1)] + [
            ("standalone", shape, dtype, n) for (shape, dtype), n in sorted(shapes.items(), key=lambda kv: -np.prod(
                kv[0][0]))]
        gen = torch.Generator().manual_seed(1)
        rows, sums = [], {a: 0.0 for a in arms}
        sums["bound"], sums["launches"] = 0.0, 0
        for what, shape, dtype, n in cases:
            x = (torch.randn(shape, generator=gen) * 3).to(device, dtype)
            xs = (x.float().abs().amax() / 127).reshape(1)
            want = quantize_int8_plain(x, xs)
            for a in ("this", "other"):
                if a in arms and not torch.equal(arms[a](x, xs), want):
                    raise AssertionError(f"the {a} kernel's codes differ from the plain version at {shape}")
            times = {a: [] for a in arms}
            for a in order:
                times[a].append(device_ms(lambda: arms[a](x, xs)))
            ms = {a: float(np.mean(t)) for a, t in times.items()}
            bound = x.numel() * (x.element_size() + 1) / HBM_BYTES_PER_S * 1e3
            rows.append({"what": what, "shape": list(shape), "dtype": str(dtype), "launches": n, "ms": ms,
                         "turns": times, "bound_ms": bound})
            print(f"{what} {shape} {str(dtype)[6:]} x{n}: " + ", ".join(
                f"{a} {' / '.join(f'{t:.4f}' for t in times[a])} ms ({bound / ms[a]:.2f} of the bound)"
                for a in arms) + f"; bound {bound:.5f} ms by bytes", flush=True)
            if what == "standalone":
                for a in arms:
                    sums[a] += n * ms[a]
                sums["bound"] += n * bound
                sums["launches"] += n
    print(f"the {sums['launches']} standalone quantizes of a fused forward, summed device time: " + ", ".join(
        f"{a} {sums[a]:.4f} ms ({sums['bound'] / sums[a]:.2f} of the bound)" for a in arms)
        + f"; bound {sums['bound']:.4f} ms (on {card})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows, "sums": sums}, f, indent=1)


if __name__ == "__main__":
    main()
