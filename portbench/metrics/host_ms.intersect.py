"""Host milliseconds an iteration inside the span of the closest hit
(``closest_surface_p``: K5, K9 or K10, K2 or an opt-in sphere route, and
their glue): the time the host takes to enqueue that stage."""

SPANS = ("art_tpu_torch.render.integrator:closest_surface_p",)


def read(ctx):
    st = ctx.stretch
    if not st or not st["iterations"] or SPANS[0] not in st["host_s"]:
        return None
    return 1e3 * st["host_s"][SPANS[0]] / st["iterations"]
