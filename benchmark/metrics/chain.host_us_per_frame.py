"""Host microseconds in ``StreamingTracker.feed`` a frame over the window:
staging the frame and, every chain of k frames, the replay of the
captured chain (``models/device_sequence.sequence_chain_device`` through
``serving._advance``). The benchmark's own spans around the call."""


def read(ctx):
    n = ctx.spans.count("feed")
    if ctx.mode != "video" or not n:
        return None
    return ctx.spans.total_ns("feed") / n / 1e3
