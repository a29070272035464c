"""Host microseconds of tracking a frame: the program's ``vo.track`` spans
inside the traced slice (each frame's staging; at a keyframe interval's
last frame the chained call and its one pull), summed, over the slice's
frames. Host time under the profiler."""

from program import span_per_row_us


def read(ctx):
    return span_per_row_us(ctx, "vo.track", "vo_drive")
