"""Camera samples (pixel-samples) completed in the window over the window's
wall time: a user's time to a finished image is pixels x spp over it."""

SPANS = ()


def read(ctx):
    return ctx.window.samples / ctx.window.seconds / 1e6
