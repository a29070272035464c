"""Host microseconds a frame in the program's ``serving.stage`` spans over
the traced slice: ``StreamingTracker.feed`` staging the fed frame
(``utils/staging.stage_raw``: the pinned block, the host copy, the copy
to the card). Host time under the profiler."""

from program import span_per_row_us


def read(ctx):
    return span_per_row_us(ctx, "serving.stage", "video")
