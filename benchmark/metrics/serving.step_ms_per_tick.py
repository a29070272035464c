"""Host milliseconds a tick in the program's ``serving.step`` spans over
the traced slice: the B streams' eager steps (``sequence_step_device``:
the pyramid, the track call, the refill), summed. Host time under the
profiler."""

from program import span_per_row_us


def read(ctx):
    us = span_per_row_us(ctx, "serving.step", "lockstep")
    return None if us is None else us / 1e3
