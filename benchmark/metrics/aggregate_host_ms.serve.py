"""Sample aggregation: the median over served batches of the program's
`serve.aggregate` span (models/postprocess.get_inference_fn: each sample's
boxes composed with their poses into the global frame, their BEV IoU and
the scan of ops/sample_bev_nms.py; its children `bev.iou` and `bev.scan`),
in ms of host time. Read from the program's span table
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
        if name == "serve.aggregate" and rows[root][0] == "serve":
            per_batch[root] = per_batch.get(root, 0) + end - start
    return 1e-6 * median(per_batch.values()) if per_batch else None
