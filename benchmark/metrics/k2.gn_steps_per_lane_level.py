"""Gauss-Newton steps K2 ran (``lk_pyramid_kernel``) over the (lane, level)
pairs it entered: the device counters ``k2.gn_steps`` over
``k2.lane_levels``, process totals over the run. The configuration's
``max_iterations`` bounds it; a level's first step that fails (a small
determinant, out of bounds) counts none."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "k2.gn_steps", "k2.lane_levels", "video")
