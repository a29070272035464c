"""Profiler-trace analysis: device busy time, ops per call, top ops.

Port of ``pyfeaturetrack_tpu/utils/traceview.py`` on ``torch.profiler``.
``capture_device_trace`` runs a callable under the profiler with CUDA
activity and writes a Chrome trace; ``parse_device_trace`` reduces the
newest trace under a directory to the JAX module's keys.

The device lane is the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. Busy time is the union of their intervals on each
stream (overlapping events count once), summed over streams, not the sum
of their durations (``sum_durations_ms`` keeps that for comparison).
Module events are the ``gpu_user_annotation`` ranges (``record_function``
/ ``utils/profiling.named_scope`` projected onto the card): they span
their member kernels, so they are reported per name and kept out of busy
time. Host-lane events (``cpu_op``, ``cuda_runtime``, ``python_function``,
``user_annotation``, ...) are ignored.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MODULE_CATEGORY = "gpu_user_annotation"


def capture_device_trace(fn, n_calls: int = 10, trace_dir: str | None = None,
                         settle_s: float = 2.0) -> dict:
    """Run ``fn()`` ``n_calls`` times under torch.profiler (CPU and CUDA
    activity), synchronize the card, export the Chrome trace into
    ``trace_dir`` (a new temporary directory when None) and return
    ``parse_device_trace`` of it. ``settle_s``: seconds the capture stays
    open after the synchronize (the JAX signature; the synchronize already
    waits for the work). Raises RuntimeError without a card: there is no
    device lane to read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError("capture_device_trace: no CUDA device; a host "
                           "trace holds no device time")
    d = trace_dir or tempfile.mkdtemp(prefix="pft_trace_")
    os.makedirs(d, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        if settle_s:
            time.sleep(settle_s)
    prof.export_chrome_trace(os.path.join(
        d, f"pft_{time.time_ns()}.trace.json"))
    return parse_device_trace(d, n_calls=n_calls)


def _newest_trace(trace_dir: str) -> str:
    files = [f for pat in ("*.json", "*.json.gz") for f in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(
            f"(traceview) no *.json or *.json.gz trace under {trace_dir}")
    return max(files, key=lambda f: (os.path.getmtime(f), f))


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cs, ce = 0.0, None, None
    for s, t in sorted(intervals):
        if ce is None or s > ce:
            if ce is not None:
                total += ce - cs
            cs, ce = s, t
        else:
            ce = max(ce, t)
    return total + (ce - cs if ce is not None else 0.0)


def parse_device_trace(trace_dir: str, n_calls: int = 1) -> dict:
    """Parse the newest Chrome trace (``*.json`` or ``*.json.gz``) under
    ``trace_dir``: device busy time (the per-stream interval union of the
    device lane), per call, the summed durations, op and module event
    counts, module time per name, the device lane's span and the top eight
    ops by summed time. Raises FileNotFoundError where there is no trace."""
    tr = _load(_newest_trace(trace_dir))
    ev = tr.get("traceEvents", []) if isinstance(tr, dict) else tr
    total_us = 0.0
    n_op_events = 0
    n_module_events = 0
    by_name: collections.Counter = collections.Counter()
    modules: collections.Counter = collections.Counter()
    intervals: dict = collections.defaultdict(list)
    t_min, t_max = None, None
    for e in ev:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        dur = float(e.get("dur", 0.0))
        if cat == MODULE_CATEGORY:
            n_module_events += 1
            modules[e.get("name", "")] += dur
        elif cat in DEVICE_CATEGORIES:
            ts = float(e.get("ts", 0.0))
            args = e.get("args") or {}
            stream = (e.get("pid"), args.get("stream", e.get("tid")))
            by_name[e.get("name", "")] += dur
            total_us += dur
            n_op_events += 1
            intervals[stream].append((ts, ts + dur))
            t_min = ts if t_min is None else min(t_min, ts)
            t_max = ts + dur if t_max is None else max(t_max, ts + dur)
    union_us = sum(_union_us(iv) for iv in intervals.values())
    calls = max(n_calls, 1)
    return {
        "n_calls": n_calls,
        "device_busy_ms": round(union_us / 1e3, 6),
        "per_call_ms": round(union_us / 1e3 / calls, 6),
        "sum_durations_ms": round(total_us / 1e3, 6),
        "op_events": n_op_events,
        "ops_per_call": n_op_events // calls,
        "module_events": n_module_events,
        "module_events_ms": {k: round(v / 1e3, 6) for k, v in
                             modules.most_common()},
        "span_ms": round((t_max - t_min) / 1e3, 6) if t_min is not None
        else 0.0,
        "top_ops": [(k, round(v / 1e3, 6)) for k, v in
                    by_name.most_common(8)],
    }
