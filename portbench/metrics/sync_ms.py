"""Milliseconds an iteration the host loop blocked in its reads of the device
(the ``sync`` spans: the exit check every few iterations, each dispatch's
``hist.cpu()`` and ``int(lost)``), the window's dispatch records
(``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "sync")
