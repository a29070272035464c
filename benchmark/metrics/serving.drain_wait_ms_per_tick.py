"""Host milliseconds in ``drain`` a tick (the wait for the card to finish
the tick and the copy of its positions to the host), averaged over the
window's ticks: the benchmark's own spans around the call."""


def read(ctx):
    n = ctx.spans.count("drain")
    if ctx.mode != "lockstep" or not n:
        return None
    return ctx.spans.total_ns("drain") / n / 1e6
