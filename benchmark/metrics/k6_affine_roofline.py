"""K6's share of its roofline over the traced slice (percent): the least
time the slice's affine stages need (``counts.k6``: the lanes checked
against their templates and their Gauss-Newton updates, the work KLT's
algorithm defines) over the device time of ``stage_kernel``
(csrc/affine.cu). A frame's checked lanes and updates are the run's means
from the device counters ``k6.checked_lanes`` and ``k6.gn_steps`` over the
frames stepped (``serving.ticks`` less each stream's first frame, which
only selects); a program without them gives None."""

import counts
from program import counters


def read(ctx):
    if ctx.mode != "video_warp" or ctx.trace is None:
        return None
    got = counters()
    if got is None or not got.get("k6.checked_lanes"):
        return None
    steps = got.get("serving.ticks", 0) - ctx.streams
    if steps <= 0:
        return None
    checked = got["k6.checked_lanes"] / steps
    updates = got["k6.gn_steps"] / steps

    def _count(klt, h, w, prev_val, val):
        return counts.k6(klt, int(val.shape[-1]), checked, updates)
    return ctx.roofline(("stage_kernel",), _count)
