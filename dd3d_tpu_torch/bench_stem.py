"""Time DLA's full-resolution stem on the card: the three convs as the
unfused path runs them (cuDNN's bf16 conv, PyTorch's bias add and ReLU,
after DD3D.preprocess_image's four f32 passes) against the stem kernel
(ops/stem_conv.py) and its plain version.

    python -m dd3d_tpu_torch.bench_stem [--batch 128] [--height 384] [--width 1280] [--out FILE]

Shapes: `base_layer` 7x7 3 -> 16 on the uint8 frames, `level0` 3x3 16 -> 16,
`level1` 3x3/2 16 -> 32, at the benchmark cells' batch 128 and 384x1280
canvas; random frames, and random folded bf16 weights and biases. Arms, a
call each, device time from one CUDA profiler window of calls (in turns:
kernel, cudnn, plain, then backwards, twice; medians), with each kernel
name's share:
- `preprocess`: DD3D.preprocess_image (uint8 -> f32, - mean, / std, -> bf16);
- `cudnn` (each conv): F.conv2d with the bf16 bias, then F.relu: the
  unfused ConvNorm on the card (PyTorch runs the bias as a separate add_);
- `kernel` (each conv; `base_layer`'s reads the frames);
- `plain` (each conv): `stem_conv_plain`, f32 conv with TF32 off.
Each kernel output is first compared with the plain version
(`stem_conv_error`), and so is cuDNN's. Each line gives the conv's least
time, the larger of its bytes (input read once, bf16 output written once;
the frames at a byte a value) at 3.35 TB/s and its operations at 989
TFLOP/s bf16, and the chain's (the frames in, level1's output out, all
operations), which the benchmark's `stem_conv_roofline` reads. Needs a CUDA card and nvcc; the
summary goes to `--out` as JSON.
"""
import argparse
import json
import subprocess

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
PIXEL_MEAN = (103.530, 116.280, 123.675)  # configs/defaults.py's MODEL.PIXEL_MEAN / PIXEL_STD (BGR)
PIXEL_STD = (57.375, 57.120, 58.395)
# name, kernel size, stride, input channels, output channels
CONVS = (("base_layer", 7, 1, 3, 16), ("level0", 3, 1, 16, 16), ("level1", 3, 2, 16, 32))


def ulp_bf16(m: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each magnitude |m| (f32): 2^(e - 8)
    for m in [2^(e-1), 2^e), no finer than the smallest subnormal."""
    _, e = torch.frexp(m.float().abs())
    return torch.ldexp(torch.ones_like(m, dtype=torch.float32), (e - 8).clamp(min=-133))


def stem_conv_error(got: torch.Tensor, x, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> dict:
    """How far an output `got` of the stem conv lies from `stem_conv_plain`'s.
    Both sum the same bf16 products in f32 in other orders (within
    K * 2^-24 * sum|x * w| of the exact sum each), then round twice: the sum
    to bf16, then sum + bias to bf16. Where the two sums straddle a rounding
    boundary the first rounding differs by one ulp, and a tie of the second
    can add one more, so the bound is one bf16 ulp a rounding, at the larger
    of the rounded sum and the output: `max_ulps` (<= 2), `beyond` (elements
    past two such ulps and the sums' order error: 0), and the share of
    outputs equal bit for bit."""
    from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames, stem_conv_plain

    import torch.nn.functional as F

    want = stem_conv_plain(x, weight, bias, stride).float()
    xn = x.normalized() if isinstance(x, NormalizedFrames) else x
    pad = (weight.shape[-1] - 1) // 2
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=cudnn.deterministic, allow_tf32=False):
        rounded = F.conv2d(xn.float(), weight.float(), None, stride, pad).to(torch.bfloat16).float()
        k = weight[0].numel()
        order = 2 * k * 2.0 ** -24 * F.conv2d(xn.float().abs(), weight.float().abs(), None, stride, pad)
    unit = ulp_bf16(torch.maximum(rounded.abs(), want.abs()))
    diff = (got.float() - want).abs()
    return {"max_ulps": float((diff / unit).max()), "beyond": int((diff > 2 * unit + order).sum()),
            "equal_share": float((diff == 0).float().mean()), "elements": diff.numel()}


def kernel_ms(fn, reps: int) -> dict:
    """{kernel name: device ms a call of `fn`}: one CUDA profiler window over
    `reps` calls, after one call outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)) / 1e3 / reps
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")}


def conv_bound_ms(b, h, w, k, stride, c, o, in_bytes):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    ops = 2 * b * ho * wo * o * c * k * k
    nbytes = b * h * w * c * in_bytes + b * ho * wo * o * 2
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, ops, nbytes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", help="write the summary here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_stem: needs a CUDA card")
    import torch.nn.functional as F

    from dd3d_tpu_torch.ops.stem_conv import NormalizedFrames, stem_conv, stem_conv_plain

    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    b, h, w = args.batch, args.height, args.width
    gen = torch.Generator(device=device).manual_seed(0)
    frames_u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8, device=device)
    mean = torch.tensor(PIXEL_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD, device=device).view(1, 3, 1, 1)
    frames = NormalizedFrames(frames_u8, mean, std, torch.bfloat16)
    print(f"bench_stem on {card}: batch {b}, {h}x{w}", flush=True)

    rows, chain_ops = [], 0
    x_kernel = frames
    pre_ms = kernel_ms(frames.normalized, args.reps)
    print(f"bench_stem preprocess: {sum(pre_ms.values()):.4f} ms device time a call; "
          + ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(pre_ms.items(), key=lambda kv: -kv[1])), flush=True)
    for name, k, stride, c, o in CONVS:
        weight = (torch.randn((o, c, k, k), generator=gen, device=device) * (2.0 / (c * k * k)) ** 0.5)
        weight = weight.to(torch.bfloat16)
        bias = (torch.randn((o,), generator=gen, device=device) * 0.1).to(torch.bfloat16)
        x_in = x_kernel
        x_t = x_in.normalized() if isinstance(x_in, NormalizedFrames) else x_in
        arms = {
            "kernel": lambda: stem_conv(x_in, weight, bias, stride),
            "cudnn": lambda: F.relu(F.conv2d(x_t, weight, bias, stride, (k - 1) // 2)),
            "plain": lambda: stem_conv_plain(x_in, weight, bias, stride),
        }
        got = arms["kernel"]()
        err = stem_conv_error(got, x_in, weight, bias, stride)
        err_cudnn = stem_conv_error(arms["cudnn"](), x_in, weight, bias, stride)
        print(f"bench_stem {name}: kernel against plain: {err}; cuDNN against plain: {err_cudnn}", flush=True)
        turns = {arm: [] for arm in arms}
        by_kernel = {arm: {} for arm in arms}
        for arm in (list(arms) + list(arms)[::-1]) * 2:
            t = kernel_ms(arms[arm], args.reps if arm != "plain" else 2)
            turns[arm].append(sum(t.values()))
            by_kernel[arm] = t
        ms = {arm: float(np.median(v)) for arm, v in turns.items()}
        bound, ops, nbytes = conv_bound_ms(b, h, w, k, stride, c, o, 1 if name == "base_layer" else 2)
        chain_ops += ops
        rows.append({"conv": name, "ms": ms, "turns": turns, "by_kernel": by_kernel, "bound_ms": bound,
                     "ops": ops, "bytes": nbytes, "error": err,
                     "cudnn_error": err_cudnn})
        print(f"bench_stem {name} ({k}x{k}/{stride}, {c} -> {o}): medians "
              + ", ".join(f"{arm} {t:.4f}" for arm, t in ms.items()) + f" ms; bound {bound:.4f} ms "
              f"({bound / ms['kernel']:.3f} of it on the kernel, {bound / ms['cudnn']:.3f} on cuDNN)", flush=True)
        for arm in ("cudnn", "kernel"):
            print(f"  {arm}: " + ", ".join(f"{kk[:70]} {v:.4f}" for kk, v in
                                          sorted(by_kernel[arm].items(), key=lambda kv: -kv[1])), flush=True)
        x_kernel = got
    out_bytes = b * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * 32 * 2
    chain = max((b * h * w * 3 + out_bytes) / HBM_BYTES_PER_S, chain_ops / BF16_OPS_PER_S) * 1e3
    kernels = sum(r["ms"]["kernel"] for r in rows)
    unfused = sum(r["ms"]["cudnn"] for r in rows) + sum(pre_ms.values())
    print(f"bench_stem chain: kernels {kernels:.4f} ms, unfused (preprocess + cuDNN + bias + ReLU) {unfused:.4f} ms, "
          f"least time {chain:.4f} ms ({100 * chain / kernels:.2f} % of it on the kernels)", flush=True)
    summary = {"card": card, "shape": [b, h, w], "preprocess_ms": pre_ms, "rows": rows, "chain_bound_ms": chain,
               "kernels_ms": kernels, "unfused_ms": unfused}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
