"""Device: the share of the traced window in which no operation ran on the
card, in %: 1 - (the union of the kernel, copy and set intervals) / the
window. Idle time is the host holding the card back; it moves
serve_images_per_s."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
