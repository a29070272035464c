"""Host milliseconds of the window BA a keyframe: the program's ``vo.ba``
spans inside the traced slice (the problem's assembly,
``bundle_adjust``, its pull, the scale re-anchor), summed, over the
slice's ``vo.keyframe`` spans. Host time under the profiler."""


def read(ctx):
    if ctx.mode != "vo_drive" or ctx.trace is None:
        return None
    a, b = ctx.slice_us

    def inside(name):
        return [t - s for s, t in ctx.trace.named(name) if a <= s and t <= b]

    keyframes = len(inside("vo.keyframe"))
    ba = inside("vo.ba")
    if not keyframes or not ba:
        return None
    return sum(ba) / keyframes * 1e-3
