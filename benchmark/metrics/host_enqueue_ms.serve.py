"""Serving entry (models/postprocess.get_inference_fn): the median host
time of one call of the serving entry, from the call to its return, before
the copy of the detections to the host. The benchmark's own span around
the call; the device runs behind it. Moves serve_images_per_s where the
host sets the pace."""
from harness.stats import median


def read(ctx):
    spans = ctx.spans.get("enqueue_s")
    return 1e3 * median(spans) if spans else None
