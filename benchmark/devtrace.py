"""Device-trace arithmetic over a ``torch.profiler`` Chrome trace.

Copied from the repository's trace readers (``utils/traceview.py``, the
chip smoke script's ``busy_span``) and made to answer the benchmark's
questions. The device lane is the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; busy time is the union of their intervals over all
streams, so overlapping work counts once and busy time never exceeds the
span it is taken over. The host lane holds the benchmark's own ranges
(``user_annotation``: ``slice``, ``feed``, ``drain``, ``tick``) and the
program's host operations (``cpu_op``, ``cuda_runtime``,
``cuda_driver``). Times are in microseconds, as in the trace.
"""

from __future__ import annotations

import bisect
import json
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")
ANNOTATION = "user_annotation"


class Trace:
    """The events of one trace, sorted by start."""

    def __init__(self, events: list):
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES)
        # host events nest: an outer event sorts before the inner ones
        # that start with it
        outer_first = (lambda e: (e[0], -e[1]))
        self.ranges = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("name", ""))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == ANNOTATION), key=outer_first)
        self.host_ops = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e.get("name", ""))
             for e in events if e.get("ph") == "X"
             and e.get("cat") in HOST_OP_CATEGORIES), key=outer_first)
        self.busy = union([(a, b) for a, b, _ in self.device])
        self._busy_starts = [a for a, _ in self.busy]
        self._range_starts = [a for a, _, _ in self.ranges]
        self._op_starts = [a for a, _, _ in self.host_ops]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", [])
                   if isinstance(data, dict) else data)

    def named(self, name: str) -> list:
        """(start, end) of the benchmark's ranges called ``name``."""
        return [(a, b) for a, b, n in self.ranges if n == name]

    def busy_in(self, a: float, b: float) -> float:
        """Device busy time inside [a, b]."""
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        total = 0.0
        for s, t in self.busy[i:]:
            if s >= b:
                break
            total += max(0.0, min(t, b) - max(s, a))
        return total

    def gaps_in(self, a: float, b: float) -> list:
        """(start, end) of the device's idle gaps inside [a, b]."""
        out, cur = [], a
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        for s, t in self.busy[i:]:
            if s >= b:
                break
            if t <= cur:
                continue
            if s > cur:
                out.append((cur, s))
            cur = t
        if cur < b:
            out.append((cur, b))
        return out

    def kernel_us(self, pattern: str, a: float, b: float) -> float:
        """Summed device time inside [a, b] of the kernels whose name
        holds ``pattern`` as a whole word."""
        rx = re.compile(rf"\b{re.escape(pattern)}\b")
        return sum(max(0.0, min(t, b) - max(s, a))
                   for s, t, n in self.device if rx.search(n)
                   and t > a and s < b)

    def host_at(self, t: float) -> str:
        """What the host was in at ``t``: the innermost benchmark range
        and, within it, the innermost host operation ('idle' outside
        every range)."""
        span = _innermost(self.ranges, self._range_starts, t)
        op = _innermost(self.host_ops, self._op_starts, t)
        if span is None:
            return "idle" if op is None else f"outside/{op}"
        return span if op is None else f"{span}/{op}"


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out: list = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def _innermost(events, starts, t, scan: int = 4096):
    """Name of the latest-starting event that holds ``t`` (events nest, so
    that is the innermost), looking back at most ``scan`` events."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def kernel_name(name: str) -> str:
    """A device event's name without its return type, anonymous
    namespace and argument list, at most 120 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:120] or name[:120]


def top_device_ops(trace: Trace, a: float, b: float, n: int = 10) -> list:
    """[[name, seconds]] of the ``n`` device operations that took the most
    time inside [a, b], names cut at their argument list."""
    acc: dict = {}
    for s, t, name in trace.device:
        if t <= a or s >= b:
            continue
        key = kernel_name(name)
        acc[key] = acc.get(key, 0.0) + (min(t, b) - max(s, a)) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(trace: Trace, a: float, b: float, n: int = 10) -> list:
    """[[what the host was in, seconds]]: the device's idle time inside
    [a, b], each gap charged to what the host was in at its middle, the
    ``n`` largest."""
    acc: dict = {}
    for s, t in trace.gaps_in(a, b):
        key = trace.host_at(0.5 * (s + t))
        acc[key] = acc.get(key, 0.0) + (t - s) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
