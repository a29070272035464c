"""Frames whose tracked positions the window completed (drained), summed
over the live streams, over the window's seconds by the host's clock:
from the first tick's due time to the return of the last tick's pull. On
the open loop it holds the offered rate while every tick is served within
its period, and falls once ticks queue behind one another."""


def read(ctx):
    if ctx.trace is not None:
        return None
    return ctx.window["rows"] * ctx.streams / ctx.window["seconds"]
