"""1 - the union of device activity intervals over the profiled
stretch's wall time."""

SPANS = ()


def read(ctx):
    st = ctx.stretch
    return 100.0 * (1.0 - st["busy_s"] / st["wall_s"]) if st and st["wall_s"] > 0 else None
