"""Serving entry, dispatch: kernel launches a served batch, counted in the
device trace of the window (copies and sets apart). Each launch costs the
host a few microseconds, so at a fixed device time it moves
serve_images_per_s where the host sets the pace."""


def read(ctx):
    if ctx.trace is None or not ctx.batches:
        return None
    return ctx.trace.launches / ctx.batches
