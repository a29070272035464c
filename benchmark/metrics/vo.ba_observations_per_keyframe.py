"""Observations the window BA weighs a keyframe: the program's
``vo.ba_observations`` (observations of non-zero weight handed to
``bundle_adjust``) over its ``vo.keyframes``, process totals over the
run."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "vo.ba_observations", "vo.keyframes",
                         "vo_drive")
