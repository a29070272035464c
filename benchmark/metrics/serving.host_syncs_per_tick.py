"""Waits of the host on the card a tick: the program's ``host_syncs`` over
its ``serving.ticks`` (``feed`` calls), process totals over the run. The
pull of each drain reads the exhausted flag and copies three columns."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "host_syncs", "serving.ticks", "lockstep")
