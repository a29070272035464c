"""Recorded footage: one ``StreamingTracker(chain=k)`` fed host uint8
frames as fast as it takes them, its table drained every ``drain_every``
frames. ``drain_every`` is a multiple of ``chain``, so every window frame
goes through the captured chain and a drain forces out no partial
chain."""

from __future__ import annotations

import time

from drive import SPAN_DRAIN, SPAN_FEED, SPAN_SLICE, Rows, Spans, annotate
from scene import pingpong


class Session:
    """Recorded footage through ``StreamingTracker(chain=k)``."""

    def __init__(self, pft, cfg, config: dict, frames, traffic: dict,
                 device):
        chain = int(traffic["chain"])
        self.drain_every = int(traffic["drain_every"])
        if self.drain_every % chain:
            raise ValueError("drain_every must be a multiple of chain")
        self.trace_periods = int(traffic["trace_periods"])
        self.frames = frames                      # [T, H, W] uint8
        self.tracker = pft.StreamingTracker(
            cfg, n_features=int(config["n_features"]),
            replace_lost=bool(config["replace_lost"]), chain=chain,
            device=device)
        self.rows = Rows()
        self.fed = 0
        self.spans = Spans()

    def frame_index(self, r: int) -> int:
        """Clip index of row r's frame."""
        return pingpong(r, self.frames.shape[0])

    def _feed(self, traced: bool) -> None:
        frame = self.frames[self.frame_index(self.fed)]
        with annotate(traced, SPAN_FEED):
            t0 = time.perf_counter_ns()
            self.tracker.feed(frame)
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_FEED, t0, t1)
        self.fed += 1

    def _drain(self, traced: bool) -> None:
        with annotate(traced, SPAN_DRAIN):
            t0 = time.perf_counter_ns()
            cols = self.tracker.drain()
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_DRAIN, t0, t1)
        self.rows.add(cols)

    def period(self, traced: bool = False) -> None:
        for _ in range(self.drain_every):
            self._feed(traced)
        self._drain(traced)

    def setup(self) -> None:
        """The first frame's selection, one drain period (the chain's
        capture is its first replay) and its drain."""
        self._feed(False)
        self.period()

    def window(self, seconds: float) -> dict:
        """Drain periods until ``seconds`` have passed; returns the
        window's first row, rows and seconds."""
        self.spans = Spans()
        first = self.rows.n
        t0 = time.perf_counter()
        while True:
            self.period()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"first_row": first, "rows": self.rows.n - first,
                "seconds": elapsed}

    def traced_slice(self) -> tuple:
        """The traffic's ``trace_periods`` drain periods inside one
        ``slice`` range; returns (first row, rows, spans of the slice)."""
        spans, self.spans = self.spans, Spans()
        first = self.rows.n
        with annotate(True, SPAN_SLICE):
            t0 = time.perf_counter_ns()
            for _ in range(self.trace_periods):
                self.period(traced=True)
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_SLICE, t0, t1)
        sliced, self.spans = self.spans, spans
        return first, self.rows.n - first, sliced

    def close(self) -> None:
        self.tracker = None
