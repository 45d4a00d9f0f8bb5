"""Kernels (csrc/int8_conv.cu): the int8 conv kernel's share of its
roofline, in %: the least time of the window's int8 conv work over the
device time of the `int8_conv_kernel` launches in the trace.

The work is counted from the configuration's layer shapes (the reference's
conv sites at the cell's batch and canvas), not from the program: every
conv of at least the configuration's QUANT_MIN_CH input channels, once a
forward, a forward a served batch. Convs that read one tensor read it once
(the program may merge them into one launch); outputs are counted at one
byte, the s8 epilogue's, so the bound is never above the least time of any
implementation. A group's least time is the larger of its bytes at the
memory rate and its operations at the int8 peak (reference/bounds.py).
Moves serve_images_per_s."""
from reference.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S, conv_ops, conv_out_hw


def forward_bound_s(sites, min_ch: int) -> float:
    groups = {}
    for s in sites:
        if s["x"][1] >= min_ch and s["groups"] == 1:
            groups.setdefault(s["input"], []).append(s)
    total = 0.0
    for convs in groups.values():
        b, c, h, w = convs[0]["x"]
        nbytes, ops = b * c * h * w, 0
        for s in convs:
            o, cg, kh, kw = s["w"]
            ho, wo = conv_out_hw(h, w, kh, s["stride"], s["pad"])
            nbytes += o * cg * kh * kw + b * ho * wo * o + 8 * o
            ops += conv_ops(s["x"], s["w"], s["stride"], s["pad"])
        total += max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["int8"])
    return total


def read(ctx):
    quant = ctx.cell.config.get("static_int8")
    if ctx.trace is None or not quant:
        return None
    seconds, launches = ctx.trace.kernel_seconds(lambda name: "int8_conv_kernel" in name)
    if not launches or seconds <= 0:
        return None
    return 100.0 * ctx.batches * forward_bound_s(ctx.sites(), int(quant["min_ch"])) / seconds
