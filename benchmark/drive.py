"""What every way of driving the program shares: the spans around each
call into it, and the drained rows.

A traffic file's ``mode`` names the module ``modes/<mode>.py`` whose
``Session`` drives the program (``run.load``); each mode builds on this
module.

A span is (name, start ns, end ns) on the host's perf counter, kept in
memory. In a traced slice each call also runs under a
``torch.profiler.record_function`` range of the same name, which puts it
on the trace's host timeline beside the device's kernels.
"""

from __future__ import annotations

import contextlib

SPAN_FEED = "feed"
SPAN_DRAIN = "drain"
SPAN_TICK = "tick"
SPAN_SLICE = "slice"


class Spans:
    """Host spans of the benchmark's calls into the program."""

    def __init__(self):
        self.names: list = []
        self.t0: list = []
        self.t1: list = []

    def add(self, name: str, t0: int, t1: int) -> None:
        self.names.append(name)
        self.t0.append(t0)
        self.t1.append(t1)

    def total_ns(self, name: str) -> int:
        return sum(b - a for n, a, b in zip(self.names, self.t0, self.t1)
                   if n == name)

    def count(self, name: str) -> int:
        return sum(n == name for n in self.names)


def annotate(traced: bool, name: str):
    if not traced:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Rows:
    """The program's drained rows in feed order: row r is frame r's
    (x, y, val), [N] for one stream or [B, N] for B."""

    def __init__(self):
        self.parts: list = []      # (first row, (x, y, val) arrays)
        self.n = 0

    def add(self, cols) -> None:
        self.parts.append((self.n, cols))
        self.n += cols[0].shape[0]

    def row(self, r: int):
        for first, cols in reversed(self.parts):
            if r >= first:
                return tuple(c[r - first] for c in cols)
        raise IndexError(r)
