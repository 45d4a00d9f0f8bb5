"""Sample aggregation: the program's own counter of BEV scan calls on the
card (ops/nms_kernel.greedy_nms_scan: its pack and scan kernels, one call
of the wrapper each time), per served batch. Two where both walks run on
the card, the per-image BEV NMS and the sample's; a walk moved to the host
or merged into another shows here. Moves serve_images_per_s."""

COUNTERS = {"greedy_nms_scan.launches": "dd3d_tpu_torch.ops.nms_kernel:greedy_nms_scan"}


def read(ctx):
    n = ctx.counters.get("greedy_nms_scan.launches", 0)
    return n / ctx.batches if n and ctx.batches else None
