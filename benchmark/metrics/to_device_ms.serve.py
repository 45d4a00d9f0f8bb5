"""Serving entry, frame copy: the median over served batches of the
program's `serve.to_device` span (models/postprocess.get_inference_fn: the
host frames and intrinsics to the card, a synchronous copy from pageable
memory), in ms. Read from the program's span table
(utils/profiling.spans()), which holds the traced window only; each `serve`
root is one batch. Moves serve_images_per_s where the host sets the pace."""
from harness.stats import median


def read(ctx):
    try:
        from dd3d_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    rows = spans()
    per_batch = {}
    for name, start, end, _, root in rows:
        if name == "serve.to_device" and rows[root][0] == "serve":
            per_batch[root] = per_batch.get(root, 0) + end - start
    return 1e-6 * median(per_batch.values()) if per_batch else None
