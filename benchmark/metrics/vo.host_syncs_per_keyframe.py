"""Waits of the host on the card a keyframe: the program's ``host_syncs``
over its ``vo.keyframes``, process totals over the run (the interval's
pull, the pose's, the points', the BA's groupings, check and pull)."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "host_syncs", "vo.keyframes", "vo_drive")
