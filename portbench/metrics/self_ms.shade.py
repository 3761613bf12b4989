"""Self milliseconds an iteration in the program's ``shade`` spans
(``shade_params_p`` on plane-fed scenes, K3, their glue; less the ``textures``
spans inside them), the window's dispatch records (``portbench/recorder.py``)."""

from portbench import recorder

SPANS = ()


def read(ctx):
    return recorder.self_ms(ctx, "shade")
