"""K4's share of its roofline over the traced slice (percent): the least
time the slice's refills need (``counts.k4``) over the device time of
``lattice_kernel`` and ``chain_kernel`` (csrc/extract.cu)."""

import counts


def _count(klt, h, w, prev_val, val):
    return counts.frame_counts(klt, h, w, prev_val, val)["k4"]


def read(ctx):
    if ctx.mode != "video":
        return None
    return ctx.roofline(("lattice_kernel", "chain_kernel"), _count)
