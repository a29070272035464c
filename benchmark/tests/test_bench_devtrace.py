"""The device-trace arithmetic on a synthetic Chrome trace."""

import json

import pytest

import devtrace


def ev(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **kw}


EVENTS = [
    ev("user_annotation", "slice", 0, 100),
    ev("user_annotation", "feed", 0, 40),
    ev("user_annotation", "drain", 60, 40),
    ev("cpu_op", "aten::copy_", 5, 10),
    ev("cuda_runtime", "cudaGraphLaunch", 30, 5),
    ev("kernel", "void (anonymous namespace)::level0_kernel<float, true>(float const*)",
       10, 20, args={"stream": 7}),
    ev("kernel", "void (anonymous namespace)::coarse_kernel<float>(float*)",
       25, 10, args={"stream": 7}),
    ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 50, 10,
       args={"stream": 9}),
    ev("kernel", "lk_pyramid_kernel(float*)", 90, 20, args={"stream": 7}),
    ev("gpu_user_annotation", "feed", 10, 30),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return devtrace.Trace.load(str(path))


def test_busy_is_the_union(trace):
    # kernels 10-30 and 25-35 overlap: 10-35; memcpy 50-60; LK 90-110
    assert trace.busy == [(10.0, 35.0), (50.0, 60.0), (90.0, 110.0)]
    assert trace.busy_in(0, 100) == pytest.approx(25 + 10 + 10)
    assert trace.busy_in(20, 55) == pytest.approx(15 + 5)


def test_gaps(trace):
    assert trace.gaps_in(0, 100) == [(0, 10.0), (35.0, 50.0), (60.0, 90.0)]
    assert trace.gaps_in(12, 30) == []


def test_kernel_time_by_whole_name(trace):
    assert trace.kernel_us("level0_kernel", 0, 100) == pytest.approx(20)
    assert trace.kernel_us("coarse_kernel", 0, 30) == pytest.approx(5)
    assert trace.kernel_us("lk_pyramid_kernel", 0, 100) == pytest.approx(10)
    assert trace.kernel_us("level0", 0, 100) == 0


def test_ranges_and_host_labels(trace):
    assert trace.named("slice") == [(0.0, 100.0)]
    assert trace.host_at(7) == "feed/aten::copy_"
    assert trace.host_at(32) == "feed/cudaGraphLaunch"
    assert trace.host_at(45) == "slice"
    assert trace.host_at(70) == "drain"
    assert trace.host_at(150) == "idle"


def test_breakdown(trace):
    ops = devtrace.top_device_ops(trace, 0, 100)
    assert ops[0] == ["level0_kernel<float, true>", pytest.approx(20e-6)]
    assert [n for n, _ in ops] == ["level0_kernel<float, true>",
                                   "coarse_kernel<float>", "Memcpy HtoD",
                                   "lk_pyramid_kernel"]
    idle = dict(devtrace.idle_by_host(trace, 0, 100))
    assert idle == {"drain": pytest.approx(30e-6),
                    "slice": pytest.approx(15e-6),
                    "feed/aten::copy_": pytest.approx(10e-6)}
