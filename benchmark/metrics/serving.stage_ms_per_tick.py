"""Host milliseconds a tick in the program's ``serving.stage`` spans over
the traced slice: ``BatchedStreamingTracker.feed`` staging the tick's B
frames in one copy (``utils/staging.stage_raw``). Host time under the
profiler."""

from program import span_per_row_us


def read(ctx):
    us = span_per_row_us(ctx, "serving.stage", "lockstep")
    return None if us is None else us / 1e3
