"""What the per-layer metrics read from inside the program: its spans in
the traced slice and its counters (``pyfeaturetrack_tpu_torch.utils.
profiling``).

A span is one of the program's own ``torch.profiler`` ranges (its
``SPANS``), on the trace's host timeline beside the benchmark's ranges:
host time under the profiler, so a traced slice reads it higher than an
untraced window would. A counter is a process total over the run's set-up,
window and traced slice. A program that opens no such span or keeps no
such counter gives None, and the metric is left out of the result line.
"""

from __future__ import annotations


def span_per_row_us(ctx, name: str, mode: str) -> float | None:
    """Microseconds of the program's ranges ``name`` inside the traced slice,
    summed, over the slice's rows (frames of one stream, or ticks); None
    outside ``mode``, untraced, or where the slice holds no such range."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    a, b = ctx.slice_us
    inside = [t - s for s, t in ctx.trace.named(name) if a <= s and t <= b]
    rows = ctx.slice_rows[1]
    if not inside or not rows:
        return None
    return sum(inside) / rows


def counters() -> dict | None:
    """The program's counters, or None where it keeps none."""
    from pyfeaturetrack_tpu_torch.utils import profiling
    read = getattr(profiling, "counters", None)
    return None if read is None else read()


def counter_ratio(ctx, num: str, den: str, mode: str) -> float | None:
    """Counter ``num`` over counter ``den``; None outside ``mode``, where the
    program keeps neither, or where ``den`` is 0."""
    if ctx.mode != mode:
        return None
    got = counters()
    if got is None or num not in got or not got.get(den):
        return None
    return got[num] / got[den]
