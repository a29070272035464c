"""Share of each traced tick's span, from the start of its feed to the
return of its drain, in which the card ran no kernel, copy or fill,
summed over the traced ticks (percent)."""


def read(ctx):
    if ctx.mode != "lockstep" or ctx.trace is None:
        return None
    ticks = ctx.trace.named("tick")
    span = sum(b - a for a, b in ticks)
    if span <= 0:
        return None
    busy = sum(ctx.trace.busy_in(a, b) for a, b in ticks)
    return 100.0 * (1.0 - busy / span)
