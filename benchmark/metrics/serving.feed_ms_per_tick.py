"""Host milliseconds in ``BatchedStreamingTracker.feed`` a tick (staging
the B frames and launching the B eager steps), averaged over the window's
ticks: the benchmark's own spans around the call."""


def read(ctx):
    n = ctx.spans.count("feed")
    if ctx.mode != "lockstep" or not n:
        return None
    return ctx.spans.total_ns("feed") / n / 1e6
