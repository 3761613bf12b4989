"""Shade and flush's share of its roofline: the least time of the stretch's
live rays through the material fetch (``shade_params_p``, plane-fed scenes)
and K3 (``shade_flush``), over the device time under those spans."""

from portbench import roofline

SPANS = ("art_tpu_torch.render.integrator:shade_params_p",
         "art_tpu_torch.render.integrator:shade_flush")


def read(ctx):
    st = ctx.stretch
    dev_s = sum(st["device_s"].get(s, 0.0) for s in SPANS) if st else 0.0
    if not dev_s:
        return None
    return 100.0 * roofline.shade_s(st["iterations"], st["live"], ctx.counts) / dev_s
