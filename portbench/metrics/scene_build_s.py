"""Seconds of set-up in the program's ``scene`` span (``build_scene``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.setup_s("scene")
