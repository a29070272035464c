"""The readers of the metrics that read inside the program (its spans in
the traced slice, its counters): each on a synthetic trace holding program
ranges, and on a stub counters dict, gives the expected value, and gives
None outside its mode or where the program has no such span or counter.
On a card, the check adds nothing to any of the program's counters."""

import json
import time
from types import SimpleNamespace

import pytest

import devtrace
import run
from conftest import tiny_parts

VIDEO = "vga1000_video_chain8"
LIVE = "vga1000_live30hz"


def ev(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


# a slice 0-1000 us over 4 rows; ranges outside it (after 1000) not counted
EVENTS = [
    ev("slice", 0, 1000),
    ev("feed", 10, 200), ev("serving.feed", 12, 190),
    ev("serving.stage", 14, 20), ev("chain.stage", 40, 30),
    ev("chain.replay", 80, 100),
    ev("feed", 300, 200), ev("serving.feed", 302, 190),
    ev("serving.stage", 304, 12), ev("serving.step", 320, 50),
    ev("serving.step", 380, 70), ev("chain.stage", 460, 10),
    ev("serving.stage", 1100, 500),
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return devtrace.Trace.load(str(path))


def ctx(mode, trace, rows=4):
    return run.Context(mode=mode, trace=trace, slice_us=(0.0, 1000.0),
                       slice_rows=(10, rows))


def reader(name):
    run._paths()
    return run.load("metrics", name).read


@pytest.mark.parametrize("name,mode,want", [
    ("serving.stage_us_per_frame", "video", (20 + 12) / 4),
    ("chain.stage_us_per_frame", "video", (30 + 10) / 4),
    ("chain.replay_us_per_frame", "video", 100 / 4),
    ("serving.stage_ms_per_tick", "lockstep", (20 + 12) / 4 / 1e3),
    ("serving.step_ms_per_tick", "lockstep", (50 + 70) / 4 / 1e3),
])
def test_span_readers(trace, name, mode, want):
    read = reader(name)
    assert read(ctx(mode, trace)) == pytest.approx(want)
    other = "lockstep" if mode == "video" else "video"
    assert read(ctx(other, trace)) is None
    assert read(ctx(mode, None)) is None


@pytest.mark.parametrize("name", ["serving.stage_us_per_frame",
                                  "chain.replay_us_per_frame",
                                  "serving.step_ms_per_tick"])
def test_span_readers_find_no_program_range(tmp_path, name):
    """A program without spans (the benchmark's ranges alone): None."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS[:2]}))
    tr = devtrace.Trace.load(str(path))
    mode = "lockstep" if name.endswith("tick") else "video"
    assert reader(name)(ctx(mode, tr)) is None


STUB = {"k2.gn_steps": 3000, "k2.lane_levels": 1200,
        "k4.refill_rescans": 90, "k4.refill_acceptances": 30,
        "host_syncs": 400, "serving.ticks": 100}


@pytest.mark.parametrize("name,mode,want", [
    ("k2.gn_steps_per_lane_level", "video", 2.5),
    ("k4.rescans_per_refill", "video", 3.0),
    ("serving.host_syncs_per_tick", "lockstep", 4.0),
])
def test_counter_readers(monkeypatch, trace, name, mode, want):
    from pyfeaturetrack_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(STUB))
    read = reader(name)
    assert read(ctx(mode, trace)) == pytest.approx(want)
    other = "lockstep" if mode == "video" else "video"
    assert read(ctx(other, trace)) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {k: 0 for k in STUB})
    assert read(ctx(mode, trace)) is None          # nothing to divide by
    monkeypatch.delattr(profiling, "counters")     # a program without them
    assert read(ctx(mode, trace)) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [VIDEO, LIVE])
def test_the_check_adds_nothing_to_any_counter(card, monkeypatch, cell):
    from pyfeaturetrack_tpu_torch.utils import profiling
    load, seen = run.load, {}

    def load_watched(kind, name):
        mod = load(kind, name)
        if kind != "checks":
            return mod

        def check(*args, **kw):
            before = profiling.counters()
            out = mod.check(*args, **kw)
            seen["after"], seen["before"] = profiling.counters(), before
            return out
        return SimpleNamespace(check=check, NUMBERS=mod.NUMBERS)

    monkeypatch.setattr(run, "load", load_watched)
    res = run.run(tiny_parts(cell), 2 ** 31 + 7, 0.3, False, card,
                  time.perf_counter())
    assert res["correct"] is True
    assert seen["after"] == seen["before"]
    assert seen["before"]["serving.ticks"] > 0
