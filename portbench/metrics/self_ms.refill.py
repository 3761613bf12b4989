"""Self milliseconds an iteration in the program's ``refill`` spans (K1), the
window's dispatch records (``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "refill")
