"""Frames whose tracked positions the window completed (drained), summed
over streams, over the whole window's seconds by the host's clock."""


def read(ctx):
    if ctx.trace is not None:
        return None
    return ctx.window["rows"] * ctx.streams / ctx.window["seconds"]
