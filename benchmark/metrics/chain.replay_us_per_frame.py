"""Host microseconds a frame in the program's ``chain.replay`` spans over
the traced slice: every chain of k frames, the check (or load) of the
carried state, ``graph.replay()`` and the clones of every output
(``models/device_sequence._ChainGraph.run``). Host time under the
profiler."""

from program import span_per_row_us


def read(ctx):
    return span_per_row_us(ctx, "chain.replay", "video")
