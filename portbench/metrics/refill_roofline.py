"""The refill's share of its roofline: the least time of the stretch's
refills (each slot's live flag read, each started ray written;
``portbench/roofline.py``) over the device time of the kernels launched
under the refill span."""

from portbench import roofline

SPANS = ("art_tpu_torch.ops.refill_kernel:fused_refill",)


def read(ctx):
    st = ctx.stretch
    dev_s = sum(st["device_s"].get(s, 0.0) for s in SPANS) if st else 0.0
    if not dev_s:
        return None
    return 100.0 * roofline.refill_s(st["iterations"], ctx.window.n_slots, st["started"]) / dev_s
