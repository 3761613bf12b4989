"""Self milliseconds an iteration in the program's ``media`` spans
(``apply_media_p``, plain PyTorch), the window's dispatch records
(``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "media")
