"""int8 conv wrapper (ops/int8_conv.py, ops/quantize.py): the program's own
counters of int8 conv and standalone quantize launches, per served batch.
Fewer launches (fused links, merged convs) move serve_images_per_s."""

COUNTERS = {
    "int8_conv.launches": "dd3d_tpu_torch.ops.int8_conv:int8_conv",
    "quantize_int8.launches": "dd3d_tpu_torch.ops.quantize:quantize_int8",
}


def read(ctx):
    n = ctx.counters.get("int8_conv.launches", 0) + ctx.counters.get("quantize_int8.launches", 0)
    return n / ctx.batches if n and ctx.batches else None
