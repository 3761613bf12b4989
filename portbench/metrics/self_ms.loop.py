"""Self milliseconds an iteration of the host loop itself: the ``loop`` spans
(each iteration less its stage spans and host reads) and the ``dispatch``
spans (each dispatch outside its iterations), the window's dispatch records
(``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "loop", "dispatch")
