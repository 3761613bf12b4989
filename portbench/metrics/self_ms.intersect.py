"""Self milliseconds an iteration in the program's ``intersect`` spans
(``closest_surface_p``: K5, K9 or K10, K2 or an opt-in sphere route, and their
glue), the window's dispatch records (``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "intersect")
