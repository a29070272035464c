"""Host microseconds a frame in the program's ``chain.stage`` spans over
the traced slice: every chain of k frames copied into the captured graph's
frame buffer, after the wait for the last replay to have read its pinned
block where the graph stages from the host (``models/device_sequence``
``_ChainGraph._stage``). Host time under the profiler."""

from program import span_per_row_us


def read(ctx):
    return span_per_row_us(ctx, "chain.stage", "video")
