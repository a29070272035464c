"""Host milliseconds of one keyframe's geometry: the program's
``vo.keyframe`` spans inside the traced slice (bookkeeping, localization,
triangulation, the window BA), their mean. Host time under the
profiler."""


def read(ctx):
    if ctx.mode != "vo_drive" or ctx.trace is None:
        return None
    a, b = ctx.slice_us
    inside = [t - s for s, t in ctx.trace.named("vo.keyframe")
              if a <= s and t <= b]
    if not inside:
        return None
    return sum(inside) / len(inside) * 1e-3
