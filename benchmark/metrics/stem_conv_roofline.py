"""Kernels (csrc/stem_conv.cu): the stem kernel's share of its roofline, in
%: the least time of the window's stem work over the device time of the
`stem_conv_kernel` launches in the trace.

The work is counted from the configuration's layer shapes (the reference's
conv sites at the cell's batch and canvas), not from the program: the
sites named `base_layer`, `level0` and `level1`, once a forward, a forward a
served batch, counted as one fused chain, so that no implementation can
read above 100 %: bytes, the uint8 frames read at one byte a value and the
last site's output written at two; operations, every site's at the bf16
peak; least time, the larger of the two (reference/bounds.py). The same
work whatever implements it. None where no such kernel launched.
Moves serve_images_per_s."""
from reference.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S, conv_ops, conv_out_hw

STEM = ("base_layer", "level0", "level1")


def stem_bound_s(sites) -> float:
    chain = [s for s in sites if any(part in STEM for part in s["name"].split("."))]
    if not chain:
        return 0.0
    b, c, h, w = chain[0]["x"]
    last = chain[-1]
    o, _, k, _ = last["w"]
    ho, wo = conv_out_hw(last["x"][2], last["x"][3], k, last["stride"], last["pad"])
    nbytes = b * c * h * w + 2 * b * o * ho * wo
    ops = sum(conv_ops(s["x"], s["w"], s["stride"], s["pad"]) for s in chain)
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["bf16"])


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = ctx.trace.kernel_seconds(lambda name: "stem_conv_kernel" in name)
    if not launches or seconds <= 0:
        return None
    bound = stem_bound_s(ctx.sites())
    return 100.0 * ctx.batches * bound / seconds if bound > 0 else None
