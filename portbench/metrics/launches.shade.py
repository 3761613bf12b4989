"""Kernel, memcpy and memset nodes that the ``shade`` span (less ``textures``)
adds to the set-up's graph capture of one staged iteration, ATen glue
included (``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.launches(ctx, "shade")
