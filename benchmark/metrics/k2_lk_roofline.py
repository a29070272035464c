"""K2's share of its roofline over the traced slice (percent): the least
time the slice's track calls need (``counts.k2``) over the device time of
``lk_pyramid_kernel`` (csrc/lk.cu)."""

import counts


def _count(klt, h, w, prev_val, val):
    return counts.frame_counts(klt, h, w, prev_val, val)["k2"]


def read(ctx):
    if ctx.mode != "video":
        return None
    return ctx.roofline(("lk_pyramid_kernel",), _count)
