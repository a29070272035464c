"""Share of the lanes K6's affine stage checked that it rejected (out of
bounds, a small determinant, a large residue or a drift from the
translational track): the device counters ``k6.rejections`` over
``k6.checked_lanes``, process totals over the run. Each rejected lane is
refilled by K4."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "k6.rejections", "k6.checked_lanes",
                         "video_warp")
