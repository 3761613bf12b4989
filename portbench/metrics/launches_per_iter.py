"""Kernel, memcpy and memset nodes of one ``staged_step``, from a CUDA
graph capture in the traced run's set-up; absent where the capture fails."""

SPANS = ()


def read(ctx):
    return ctx.window.launches
