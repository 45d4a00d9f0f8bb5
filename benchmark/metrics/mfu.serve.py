"""Whole step: the served batches' conv operations at the peak of the type
each conv runs in, over the traced window, in % (model FLOPs utilization).

The operations are counted once from the configuration's layer shapes (the
reference's conv sites at the cell's batch and canvas): a conv runs in int8
where the configuration quantizes it (QUANT_MIN_CH input channels or more),
in bf16 otherwise; peaks from reference/bounds.py (int8 1979 TOP/s, bf16
989 TFLOP/s). It bounds every kernel roofline that moves the same metric:
a kernel taken off the path leaves its roofline silent, not this.
Moves serve_images_per_s."""
from reference.bounds import PEAK_OPS_PER_S, conv_ops


def forward_peak_s(sites, min_ch) -> float:
    total = 0.0
    for s in sites:
        kind = "int8" if min_ch is not None and s["x"][1] >= min_ch and s["groups"] == 1 else "bf16"
        total += conv_ops(s["x"], s["w"], s["stride"], s["pad"]) / PEAK_OPS_PER_S[kind]
    return total


def read(ctx):
    if not ctx.batches or ctx.seconds <= 0:
        return None
    quant = ctx.cell.config.get("static_int8")
    min_ch = int(quant["min_ch"]) if quant else None
    return 100.0 * ctx.batches * forward_peak_s(ctx.sites(), min_ch) / ctx.seconds
