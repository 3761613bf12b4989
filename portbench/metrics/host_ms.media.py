"""Host milliseconds an iteration inside the span of the constant media
(``apply_media_p``, plain PyTorch): the time the host takes to enqueue that
stage."""

SPANS = ("art_tpu_torch.render.integrator:apply_media_p",)


def read(ctx):
    st = ctx.stretch
    if not st or not st["iterations"] or SPANS[0] not in st["host_s"]:
        return None
    return 1e3 * st["host_s"][SPANS[0]] / st["iterations"]
