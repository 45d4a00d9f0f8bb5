"""Model forward: the median over served batches of the program's
`serve.forward` span (the model call of models/postprocess.get_inference_fn:
backbone, FPN and both heads enqueued; its children `forward.*` name the
parts), in ms of host time. The card runs behind it. Read from the
program's span table (utils/profiling.spans()), which holds the traced
window only; each `serve` root is one batch. Moves serve_images_per_s where
the host sets the pace."""
from harness.stats import median


def read(ctx):
    try:
        from dd3d_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    rows = spans()
    per_batch = {}
    for name, start, end, _, root in rows:
        if name == "serve.forward" and rows[root][0] == "serve":
            per_batch[root] = per_batch.get(root, 0) + end - start
    return 1e-6 * median(per_batch.values()) if per_batch else None
