"""Time the grouped int8 conv's `narrow` route on the card at the DLA-X
shapes it serves, against the `direct` route, cuDNN's bf16 grouped conv of
the same codes and the tensor-core alternative.

    python -m dd3d_tpu_torch.bench_grouped [--out FILE]

The shapes are DLA-X-60's four grouped convs at C/g = 4 and 8, DLA-X-60-C's
two at C/g = 2 and DLA-X-102-64's two stride-2 convs with 64 groups, at
batch 8, 384x1280 (BottleneckX's 3x3, O = C). The tensor-core alternative,
`mma_block_diagonal`, is the `mma` route on the same function written as a
conv of C/32 groups of 32 channels: each output's weights sit at its own
group's channels of its 32, zeros elsewhere, so the sums are the same and
the tensor cores do 32 / (C/g) times the multiply-adds. Every arm's bf16
output is checked equal to the plain version first. Each arm's device time
a call comes from one profiler window of 20 calls, in turns (narrow, direct,
mma_block_diagonal, cuDNN, then backwards, twice; medians), beside the byte
bound (x and w read, the bf16 output written, at 3.35 TB/s). Needs a CUDA
card and nvcc; the summary goes to `--out` as JSON.
"""
import argparse
import json

import numpy as np
import torch

from dd3d_tpu_torch.bench_quantize import HBM_BYTES_PER_S, device_ms

# (B, H, W, C, stride, groups)
SHAPES = [(8, 192, 640, 128, 2, 32), (8, 96, 320, 128, 1, 32), (8, 96, 320, 256, 2, 32), (8, 48, 160, 256, 1, 32),
          (8, 192, 640, 64, 2, 32), (8, 96, 320, 64, 1, 32), (8, 192, 640, 256, 2, 64), (8, 96, 320, 512, 2, 64)]


def block_diagonal_weights(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """wq (O, kh, kw, C/g) of a conv with O = C and C/g = O/g dividing 32, as
    the weights (O, kh, kw, 32) of the same conv in C/32 groups of 32: output
    o's weights at channels (o % 32) // (C/g) * C/g onward of its 32."""
    o, kh, kw, cg = wq.shape
    if o != cg * groups or 32 % cg or o % 32:
        raise ValueError(f"need O = C, C/g dividing 32 and C a multiple of 32; got {tuple(wq.shape)}, {groups} groups")
    first = (torch.arange(o, device=wq.device) % 32) // cg * cg
    index = (first[:, None] + torch.arange(cg, device=wq.device))[:, None, None, :].expand(o, kh, kw, cg)
    return wq.new_zeros((o, kh, kw, 32)).scatter_(3, index, wq)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the summary here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_grouped: needs a CUDA card")
    from dd3d_tpu_torch.ops.int8_conv import dequant_plain, int8_conv_grouped, int8_conv_grouped_acc_plain

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for b, h, w, c, stride, g in SHAPES:
        xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8).to(device)
        wq = torch.randint(-127, 128, (c, 3, 3, c // g), generator=gen, dtype=torch.int8).to(device)
        scale = (torch.rand(c, generator=gen) * 1e-3 + 1e-5).to(device)
        bias = torch.randn(c, generator=gen).to(device)
        wbd = block_diagonal_weights(wq, g)
        xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        arms = {
            "narrow": lambda: int8_conv_grouped(xq, wq, scale, bias, stride, 1, torch.bfloat16, g, route="narrow"),
            "direct": lambda: int8_conv_grouped(xq, wq, scale, bias, stride, 1, torch.bfloat16, g, route="direct"),
            "mma_block_diagonal": lambda: int8_conv_grouped(xq, wbd, scale, bias, stride, 1, torch.bfloat16, c // 32,
                                                            route="mma"),
            "cudnn": lambda: torch.nn.functional.conv2d(xb, wb, stride=stride, padding=1, groups=g),
        }
        want = dequant_plain(int8_conv_grouped_acc_plain(xq, wq, stride, 1, g), scale, bias, torch.bfloat16)
        for name in ("narrow", "direct", "mma_block_diagonal"):
            if not torch.equal(arms[name](), want):
                raise AssertionError(f"bench_grouped {name} at {(b, h, w, c, stride, g)}: kernel and plain differ")
        turns = {name: [] for name in arms}
        for name in (list(arms) + list(arms)[::-1]) * 2:
            turns[name].append(device_ms(arms[name]))
        ms = {name: float(np.median(t)) for name, t in turns.items()}
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        bound = (xq.numel() + wq.numel() + b * ho * wo * c * 2) / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [b, h, w, c], "stride": stride, "groups": g, "ms": ms, "turns": turns,
                     "bound_ms": bound})
        print(f"bench_grouped (B,H,W,C)=({b},{h},{w},{c}) s={stride} g={g} (C/g {c // g}): medians "
              + ", ".join(f"{name} {t:.4f}" for name, t in ms.items()) + f" ms; bound {bound:.5f} ms by bytes "
              f"({bound / ms['narrow']:.2f} of it on narrow); every kernel arm equal to the plain version",
              flush=True)
    summary = {"card": torch.cuda.get_device_name(0), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
