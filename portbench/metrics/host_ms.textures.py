"""Host milliseconds an iteration inside the span of the special textures of
baked shading (``eval_special_p``: K7's marble, K8's image fetch): the time
the host takes to enqueue that stage."""

SPANS = ("art_tpu_torch.render.integrator:eval_special_p",)


def read(ctx):
    st = ctx.stretch
    if not st or not st["iterations"] or SPANS[0] not in st["host_s"]:
        return None
    return 1e3 * st["host_s"][SPANS[0]] / st["iterations"]
