"""Tracing and timing helpers (PyTorch port of
``pyfeaturetrack_tpu/utils/profiling.py``).

``named_scope`` labels a region in profiler traces
(``torch.profiler.record_function``); ``trace`` collects a
``torch.profiler`` trace of a region (host ops and, with a card, its
kernels) into a Chrome trace file. ``time_jitted`` times calls with CUDA
events on the card (a host clock on the CPU, where there is no device
time); ``device_time_per_call`` reads the device busy time of a trace per
call (``utils/traceview``), and raises where no kernel ran on a card.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def named_scope(name: str):
    """A context manager that names the enclosed work in profiler traces."""
    return record_function(name)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Collect a torch.profiler trace of the block into
    ``log_dir/trace.json`` (Chrome trace format; CUDA kernels included
    when there is a card)."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _outputs_on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_outputs_on_card(o) for o in out)
    return False


def time_jitted(fn, *args, iters: int = 50, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA events
    around ``iters`` back-to-back calls when the outputs lie on the card
    (the host's launch time included where it exceeds the kernels'), a
    host clock ending in a synchronize otherwise."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if not _outputs_on_card(out):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def device_time_per_call(fn, *args, iters: int = 8) -> float:
    """Seconds of device time per call of ``fn(*args)``: the busy time of
    the device lane of a torch.profiler trace of ``iters`` calls
    (``utils/traceview.parse_device_trace``: kernels, copies and fills,
    their per-stream interval union) over ``iters``. Raises RuntimeError
    without a card or when the trace holds no device event: there is no
    device time to report."""
    from .traceview import capture_device_trace
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_per_call: no CUDA device; a host "
                           "time is not a device time")
    fn(*args)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        rep = capture_device_trace(lambda: fn(*args), n_calls=iters,
                                   trace_dir=tmp, settle_s=0.0)
    if not rep["op_events"]:
        raise RuntimeError("device_time_per_call: the trace holds no CUDA "
                           "kernel of the call")
    return rep["device_busy_ms"] / iters / 1e3
