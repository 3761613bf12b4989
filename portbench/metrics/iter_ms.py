"""The window's wall time over its pool iterations: the host loop's pace."""

SPANS = ()


def read(ctx):
    w = ctx.window
    return 1e3 * w.seconds / w.iterations if w.iterations else None
