"""Self milliseconds an iteration in the program's ``textures`` spans
(``eval_special_p``: K7's marble, K8's image fetch), the window's dispatch
records (``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "textures")
