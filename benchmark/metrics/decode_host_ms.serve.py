"""Decode and NMS: the median over served batches of the program's
`serve.decode` span (models/dd3d.dd3d_inference: the per-level candidates,
the candidate cap and the 2D NMS, the compaction and gather; its children
`decode.*` name the parts), in ms of host time. Read from the program's
span table (utils/profiling.spans()), which holds the traced window only;
each `serve` root is one batch. Moves serve_images_per_s where the host
sets the pace."""
from harness.stats import median


def read(ctx):
    try:
        from dd3d_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    rows = spans()
    per_batch = {}
    for name, start, end, _, root in rows:
        if name == "serve.decode" and rows[root][0] == "serve":
            per_batch[root] = per_batch.get(root, 0) + end - start
    return 1e-6 * median(per_batch.values()) if per_batch else None
