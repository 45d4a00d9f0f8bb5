"""Decode and NMS, the per-image BEV NMS: the median over served batches
of the program's `decode.bev_nms` span (models/dd3d._bev_nms_in_graph
under `serve.decode`: the detections' top faces in each camera's BEV,
their rotated IoU and the scan; its children `bev.iou` and `bev.scan`), in
ms of host time. Read from the program's span table
(utils/profiling.spans()), which holds the traced window only; each
`serve` root is one batch. None where no batch opened the span (a program
without it). Moves serve_images_per_s where the host sets the pace."""
from harness.stats import median


def read(ctx):
    try:
        from dd3d_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    rows = spans()
    per_batch = {}
    for name, start, end, _, root in rows:
        if name == "decode.bev_nms" and rows[root][0] == "serve":
            per_batch[root] = per_batch.get(root, 0) + end - start
    return 1e-6 * median(per_batch.values()) if per_batch else None
