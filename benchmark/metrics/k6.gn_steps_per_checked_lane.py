"""Gauss-Newton updates K6's affine stage ran (``stage_kernel``) over the
lanes it checked against their templates: the device counters
``k6.gn_steps`` over ``k6.checked_lanes``, process totals over the run.
The configuration's ``affine_max_iterations`` bounds it; an iteration that
ends a lane (out of bounds, a small determinant) counts none."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "k6.gn_steps", "k6.checked_lanes", "video_warp")
