"""K1's share of its roofline over the traced slice (percent): the least
time the slice's pyramid builds need (``counts.k1``, with K3's map in the
level-0 launch) over the device time of ``level0_kernel`` and
``coarse_kernel`` (csrc/pyramid.cu)."""

import counts


def _count(klt, h, w, prev_val, val):
    return counts.frame_counts(klt, h, w, prev_val, val)["k1"]


def read(ctx):
    if ctx.mode != "video":
        return None
    return ctx.roofline(("level0_kernel", "coarse_kernel"), _count)
