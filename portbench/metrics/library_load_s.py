"""Seconds of set-up in the program's ``library`` span: the kernels' library
loaded, or built by nvcc in a fresh checkout (``ops/_build.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.setup_s("library")
