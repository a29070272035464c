"""Live cameras: one ``BatchedStreamingTracker(n_streams=B, chain=1)``
on an open loop on the camera clock: tick i is due at ``start + i /
rate_hz``; at each tick one ``feed`` of the B frames, then one ``drain``
(the host pull of their positions). A tick's latency runs from its due
time to the drain's return, so a late tick also charges the wait it
imposed on the ticks behind it."""

from __future__ import annotations

import time

from drive import (SPAN_DRAIN, SPAN_FEED, SPAN_SLICE, SPAN_TICK, Rows, Spans,
                   annotate)
from scene import pingpong

WARM_TICKS = 3


class Session:
    """B live cameras through ``BatchedStreamingTracker(chain=1)``, one
    tick every 1 / rate_hz seconds on the camera clock."""

    def __init__(self, pft, cfg, config: dict, frames, traffic: dict,
                 device):
        self.rate = float(traffic["rate_hz"])
        self.streams = int(traffic["streams"])
        self.trace_ticks = int(traffic["trace_ticks"])
        self.frames = frames                      # [T, B, H, W] uint8
        self.tracker = pft.BatchedStreamingTracker(
            cfg, n_streams=self.streams,
            n_features=int(config["n_features"]),
            replace_lost=bool(config["replace_lost"]), chain=1,
            device=device)
        self.rows = Rows()
        self.fed = 0
        self.spans = Spans()
        self.latency_ms: list = []
        self.late_ms: list = []

    def frame_index(self, r: int) -> int:
        return pingpong(r, self.frames.shape[0])

    def _tick(self, traced: bool) -> None:
        batch = self.frames[self.frame_index(self.fed)]
        with annotate(traced, SPAN_TICK):
            with annotate(traced, SPAN_FEED):
                t0 = time.perf_counter_ns()
                self.tracker.feed(batch)
                t1 = time.perf_counter_ns()
            with annotate(traced, SPAN_DRAIN):
                cols = self.tracker.drain()
                t2 = time.perf_counter_ns()
        self.spans.add(SPAN_FEED, t0, t1)
        self.spans.add(SPAN_DRAIN, t1, t2)
        self.spans.add(SPAN_TICK, t0, t2)
        self.rows.add(cols)
        self.fed += 1

    def setup(self) -> None:
        """The first tick's selections and a few eager ticks."""
        for _ in range(1 + WARM_TICKS):
            self._tick(False)

    def _run(self, n_ticks: int, traced: bool) -> dict:
        self.latency_ms, self.late_ms = [], []
        start = time.perf_counter() + 0.002
        for i in range(n_ticks):
            due = start + i / self.rate
            now = time.perf_counter()
            if now < due:
                if due - now > 0.002:
                    time.sleep(due - now - 0.0015)
                while time.perf_counter() < due:
                    pass
            self.late_ms.append(max(0.0, time.perf_counter() - due) * 1e3)
            self._tick(traced)
            self.latency_ms.append((time.perf_counter() - due) * 1e3)
        return {"seconds": time.perf_counter() - start}

    def window(self, seconds: float) -> dict:
        """round(seconds * rate_hz) ticks on the camera clock."""
        self.spans = Spans()
        first = self.rows.n
        out = self._run(int(round(seconds * self.rate)), False)
        out.update(first_row=first, rows=self.rows.n - first,
                   latency_ms=self.latency_ms, late_ms=self.late_ms)
        return out

    def traced_slice(self) -> tuple:
        """The traffic's ``trace_ticks`` ticks inside one ``slice`` range;
        returns (first row, rows, spans of the slice)."""
        spans, self.spans = self.spans, Spans()
        first = self.rows.n
        with annotate(True, SPAN_SLICE):
            t0 = time.perf_counter_ns()
            self._run(self.trace_ticks, True)
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_SLICE, t0, t1)
        sliced, self.spans = self.spans, spans
        return first, self.rows.n - first, sliced

    def close(self) -> None:
        self.tracker = None
