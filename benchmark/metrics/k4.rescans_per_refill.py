"""K4's segment rescans (``chain_kernel``) over its acceptances, on
refills: the device counters ``k4.refill_rescans`` over
``k4.refill_acceptances``, process totals over the run. A rescan reads a
segment of the lattice again after an accepted box covered its maximum."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "k4.refill_rescans", "k4.refill_acceptances",
                         "video")
