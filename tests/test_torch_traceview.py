"""The port's trace reader (utils/traceview.py) on synthetic torch.profiler
Chrome traces that mirror tests/test_traceview.py's cases: busy time as the
per-stream interval union against the sum of durations, annotation ranges
kept out of busy time, host lanes ignored, the newest trace read; and the
capture, which needs a card, raising here."""

import gzip
import json
import os
import time

import pytest
import torch

from pyfeaturetrack_tpu_torch.utils import profiling
from pyfeaturetrack_tpu_torch.utils.traceview import (capture_device_trace,
                                                      parse_device_trace)


def _kernel(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
            "ts": ts, "dur": dur, "args": {"device": 0, "stream": stream}}


def _write(tmp_path, events, name="host.pt.trace.json", gz=False):
    path = tmp_path / name
    data = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    return str(tmp_path)


def test_parse_synthetic_trace(tmp_path):
    """Two calls of a step with two kernels each, under an annotation; a
    memcpy; host events ignored."""
    ev = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        # the annotation ranges projected onto the card: module events
        {"ph": "X", "cat": "gpu_user_annotation", "name": "pft.step",
         "pid": 0, "tid": 7, "ts": 0, "dur": 100.0},
        _kernel("pyramid_kernel", 0, 60.0),
        _kernel("lk_kernel", 60, 40.0),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "pft.step",
         "pid": 0, "tid": 7, "ts": 100, "dur": 100.0},
        _kernel("pyramid_kernel", 100, 55.0),
        _kernel("lk_kernel", 155, 45.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 210, 10.0,
                cat="gpu_memcpy"),
        # host-lane events
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 1, "ts": 0, "dur": 9999.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 5, "dur": 8888.0},
        {"ph": "X", "cat": "user_annotation", "name": "pft.step",
         "pid": 1, "tid": 1, "ts": 0, "dur": 7777.0},
    ]
    r = parse_device_trace(_write(tmp_path, ev), n_calls=2)
    assert r["device_busy_ms"] == pytest.approx(0.21)
    assert r["per_call_ms"] == pytest.approx(0.105)
    assert r["sum_durations_ms"] == pytest.approx(0.21)
    assert r["op_events"] == 5 and r["ops_per_call"] == 2
    assert r["module_events"] == 2
    assert r["module_events_ms"] == {"pft.step": pytest.approx(0.2)}
    assert r["span_ms"] == pytest.approx(0.22)
    top = dict(r["top_ops"])
    assert top["pyramid_kernel"] == pytest.approx(0.115)
    assert "pft.step" not in top and "aten::add" not in top
    assert r["n_calls"] == 2


def test_parse_overlap_is_a_union_per_stream(tmp_path):
    """Overlapping events on one stream count once (the union); two
    streams busy at the same time count each stream's own union."""
    ev = [
        _kernel("a", 0, 50.0),
        # a long event spanning two others on the same stream
        _kernel("span", 50, 100.0),
        _kernel("b", 55, 60.0),
        _kernel("c", 120, 25.0),
        # another stream at the same time
        _kernel("d", 0, 30.0, stream=13),
        _kernel("e", 20, 30.0, stream=13, cat="gpu_memset"),
    ]
    r = parse_device_trace(_write(tmp_path, ev), n_calls=1)
    # stream 7: [0, 150] = 150 us; stream 13: [0, 50] = 50 us
    assert r["device_busy_ms"] == pytest.approx(0.2)
    assert r["sum_durations_ms"] == pytest.approx(0.295)
    assert r["op_events"] == 6


def test_parse_reads_the_newest_trace_gz_or_json(tmp_path):
    old = _write(tmp_path, [_kernel("old", 0, 10.0)], "a.json")
    os.utime(tmp_path / "a.json", (time.time() - 100, time.time() - 100))
    sub = tmp_path / "run"
    sub.mkdir()
    _write(sub, [_kernel("new", 0, 30.0)], "b.pt.trace.json.gz", gz=True)
    r = parse_device_trace(old, n_calls=3)
    assert [k for k, _ in r["top_ops"]] == ["new"]
    assert r["per_call_ms"] == pytest.approx(0.01)


def test_parse_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_device_trace(str(tmp_path))


def test_parse_a_host_only_profiler_trace(tmp_path):
    """A real torch.profiler trace of CPU work: well formed, no device
    events, nothing counted."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.named_scope("pft.cpu_step"):
            torch.tanh(a @ a)
    prof.export_chrome_trace(str(tmp_path / "cpu.json"))
    r = parse_device_trace(str(tmp_path), n_calls=1)
    assert r["op_events"] == 0 and r["device_busy_ms"] == 0.0
    assert r["module_events"] == 0 and r["top_ops"] == []


def test_capture_and_device_time_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_device_trace(lambda: torch.zeros(1), n_calls=2,
                             trace_dir=str(tmp_path), settle_s=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_time_per_call(lambda: torch.zeros(1))
    assert not any(tmp_path.iterdir())
