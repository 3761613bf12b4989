"""Kernel, memcpy and memset nodes that the ``media`` span adds to the set-up's
graph capture of one staged iteration: the media's plain PyTorch
(``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.launches(ctx, "media")
