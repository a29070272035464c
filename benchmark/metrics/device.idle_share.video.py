"""Share of the traced slice (a fixed number of drain periods of the
video) in which the card ran no kernel, copy or fill (percent)."""


def read(ctx):
    if ctx.mode != "video" or ctx.trace is None:
        return None
    a, b = ctx.slice_us
    return 100.0 * (1.0 - ctx.trace.busy_in(a, b) / (b - a))
