"""The closest hit's share of its roofline: the least time of the stretch's
live rays through ``closest_surface_p`` (each ray's inputs and hit record
once, the scene's tables once an iteration; ``portbench/roofline.py``) over
the device time of the kernels launched under its span.  The count is the
same whichever sphere route runs."""

from portbench import roofline

SPANS = ("art_tpu_torch.render.integrator:closest_surface_p",)


def read(ctx):
    st = ctx.stretch
    dev_s = sum(st["device_s"].get(s, 0.0) for s in SPANS) if st else 0.0
    if not dev_s:
        return None
    return 100.0 * roofline.intersect_s(st["iterations"], st["live"], ctx.counts) / dev_s
