"""Live segments over pool iterations x slots in the window
(``render_wavefront``'s counts): how full the pool runs."""

SPANS = ()


def read(ctx):
    w = ctx.window
    return 100.0 * w.rays / (w.iterations * w.n_slots) if w.iterations else None
