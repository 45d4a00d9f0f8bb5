"""int8 conv wrapper: the host time of one int8 conv, in us: for each served
batch, the total of the program's `int8.conv` spans (models/layers.py: the
norm folded into the weight, the weight quantized, the activation
quantized unless a fused link hands it on, the kernel launched) over their
number; the median over batches. Per-call work that could be done once
(the weight's fold and quantize) shows here. Read from the program's span
table (utils/profiling.spans()), which holds the traced window only; each
`serve` root is one batch. Moves serve_images_per_s where the host sets
the pace."""
from harness.stats import median


def read(ctx):
    try:
        from dd3d_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    rows = spans()
    per_batch = {}
    for name, start, end, _, root in rows:
        if name == "int8.conv" and rows[root][0] == "serve":
            total, n = per_batch.get(root, (0, 0))
            per_batch[root] = (total + end - start, n + 1)
    return 1e-3 * median([t / n for t, n in per_batch.values()]) if per_batch else None
