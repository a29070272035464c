"""The port's spans and counters (``utils/profiling.py``) on the CPU: the
shared no-op when no profiler runs, the serving path's spans nested under a
CPU ``torch.profiler``, the span table against the package's sources, the
counters mirroring the kernel modules' launch ints, the host syncs of a
feed-and-drain tick, and the reset. The device counters' kernels are
checked on the card (tests/test_torch_counters_cuda.py)."""

import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import make_textured_image

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.serving import (BatchedStreamingTracker,
                                              StreamingTracker)
from pyfeaturetrack_tpu_torch.utils import profiling

torch.set_num_threads(2)

PACKAGE = Path(tpft.__file__).resolve().parent
# the benchmark's own ranges (benchmark/drive.py)
BENCHMARK_RANGES = ("feed", "drain", "tick", "slice")


def _frames(n, shape=(64, 80), seed=5):
    base = make_textured_image(*shape, seed=seed).astype(np.uint8)
    return [np.roll(base, 2 * i, axis=1) for i in range(n)]


def _ranges(prof, tmp_path) -> list:
    """(name, start, end) of the trace's program ranges, sorted by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_named_scope_is_one_shared_noop_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: made.append(name))
    scopes = [profiling.named_scope(n) for n in ("serving.feed", "step.track")]
    assert scopes[0] is scopes[1]
    with scopes[0]:
        tpft.build_track_pyramids(torch.zeros(32, 40), tpft.create_config())
    assert made == []


def _feed_and_drain(tracker, items):
    for item in items:
        tracker.feed(item)
        tracker.drain()


@pytest.mark.parametrize("batched", [False, True])
def test_serving_spans_nest_under_a_cpu_profiler(batched, tmp_path):
    """Every span of a fed frame or tick lies inside its ``serving.feed``:
    the staging, and each stream's step with its phases; the pull lies
    outside the feed. Two streams a tick when batched."""
    frames = _frames(4)
    if batched:
        tracker = BatchedStreamingTracker(tpft.create_config(), n_streams=2,
                                          n_features=20, device="cpu")
        items = [np.stack([f, f[:, ::-1]]) for f in frames]
    else:
        tracker = StreamingTracker(tpft.create_config(), n_features=20,
                                   device="cpu")
        items = frames
    streams = 2 if batched else 1
    tracker.feed(items[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _feed_and_drain(tracker, items[1:])
    ranges = _ranges(prof, tmp_path)
    names = [r[0] for r in ranges]
    feeds = [r for r in ranges if r[0] == "serving.feed"]
    assert len(feeds) == 3
    assert names.count("serving.stage") == 3
    assert names.count("serving.step") == 3 * streams
    assert names.count("serving.history") == 3
    assert names.count("serving.pull") == 3
    for phase in ("step.pyramid", "step.track", "step.refill"):
        assert names.count(phase) == 3 * streams
    assert "step.affine" not in names
    steps = [r for r in ranges if r[0] == "serving.step"]
    for r in ranges:
        if r[0] in ("serving.stage", "serving.step", "serving.history"):
            assert any(_inside(r, f) for f in feeds), r
        elif r[0].startswith("step."):
            assert any(_inside(r, s) for s in steps), r
        elif r[0] == "serving.pull":
            assert not any(_inside(r, f) for f in feeds), r
    assert set(names) <= set(profiling.SPANS)


def test_affine_step_opens_its_span(tmp_path):
    frames = _frames(2)
    tracker = StreamingTracker(
        tpft.create_config(affineConsistencyCheck=2), n_features=20,
        device="cpu")
    tracker.feed(frames[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracker.feed(frames[1])
    names = [r[0] for r in _ranges(prof, tmp_path)]
    assert names.count("step.affine") == 1


def _package_sources() -> dict:
    return {p: p.read_text() for p in PACKAGE.rglob("*.py")}


def test_span_table_matches_the_package_sources():
    """Every ``named_scope`` the package opens names a span of ``SPANS`` as a
    literal, every span of ``SPANS`` is opened somewhere, and none takes a
    name of the benchmark's own ranges."""
    used = set()
    for path, text in _package_sources().items():
        if path.name == "profiling.py":
            continue
        calls = re.findall(r"named_scope\(([^)]*)\)", text)
        for arg in calls:
            m = re.fullmatch(r'\s*"([^"]+)"\s*', arg)
            assert m, f"{path.name}: named_scope({arg}) is not a literal"
            used.add(m.group(1))
    assert used == set(profiling.SPANS)
    assert not used & set(BENCHMARK_RANGES)
    for name, (layer, covers, reader) in profiling.SPANS.items():
        assert layer and covers and reader, name


def test_counters_mirror_the_launch_ints(monkeypatch):
    """Every ``launches`` int a kernel module declares is registered once
    it is imported, and ``counters()`` reads each as ``<module>.<name>``."""
    declared = set()
    for path in (PACKAGE / "ops").glob("cuda_*.py"):
        importlib.import_module(f"{tpft.__name__}.ops.{path.stem}")
        for attr in re.findall(r"^(\w*launches) = 0$", path.read_text(),
                               flags=re.M):
            declared.add((path.stem, attr))
    registered = profiling.launch_counters()
    assert {(m.__name__.rsplit(".", 1)[-1], a)
            for m, a in registered} == declared
    assert len(registered) == len(declared)
    for i, (mod, attr) in enumerate(registered):
        monkeypatch.setattr(mod, attr, 1000 + i)
    got = profiling.counters()
    for i, (mod, attr) in enumerate(registered):
        assert got[f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"] == 1000 + i


def test_a_tick_counts_the_pulls_four_host_syncs():
    """One feed-and-drain tick of a BatchedStreamingTracker of B streams:
    one tick, and the pull's four host syncs (the exhausted read and the
    three copies), on CPU tensors too."""
    b, frames = 3, _frames(2)
    tracker = BatchedStreamingTracker(tpft.create_config(), n_streams=b,
                                      n_features=20, device="cpu")
    tracker.feed(np.stack([frames[0]] * b))
    tracker.drain()
    before = profiling.counters()
    tracker.feed(np.stack([frames[1]] * b))
    tracker.drain()
    after = profiling.counters()

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)

    assert grew("serving.ticks") == 1
    assert grew("host_syncs") == 4
    assert grew("sync.pull_exhausted") == 1
    assert grew("sync.pull_copy") == 3


def test_reset_zeroes_every_counter(monkeypatch):
    """Host, launch and device counters all read 0 after a reset; the
    device buffers are zeroed in place and summed over their slots."""
    buf = torch.zeros((len(profiling.DEVICE_COUNTERS),
                       profiling.DEVICE_SLOTS), dtype=torch.int64)
    buf[0, :3] = torch.tensor([2, 3, 4])
    buf[3, 63] = 7
    monkeypatch.setattr(profiling, "_device", {0: buf})
    profiling.count("serving.ticks", 5)
    profiling.host_sync("sync.block")
    mod, attr = profiling.launch_counters()[0]
    monkeypatch.setattr(mod, attr, 12)
    got = profiling.counters()
    assert got["k2.gn_steps"] == 9 and got["k4.refill_rescans"] == 7
    assert got["serving.ticks"] >= 5 and got["host_syncs"] >= 1
    profiling.reset_counters()
    assert all(v == 0 for v in profiling.counters().values())
    assert profiling._device[0] is buf and not buf.any()


def test_plain_affine_stage_counts_a_known_lane_mix():
    """K6's plain stage (the CPU route) adds to the device counters what its
    kernel adds on the card (tests/test_torch_counters_cuda.py): the lanes
    it checked against their templates, their Gauss-Newton updates (the
    iteration cap for each lane that passes) and the lanes it rejected."""
    from _affine_lanes import lane_mix
    from pyfeaturetrack_tpu_torch.ops import affine

    mix = lane_mix("cpu")
    cfg, g, after = mix["cfg"], mix["groups"], mix["after"]
    names = ("k6.checked_lanes", "k6.gn_steps", "k6.rejections")
    before = {k: profiling.counters()[k] for k in names}
    out = affine.affine_consistency_check(mix["pyr1"], mix["pyr2"],
                                          mix["before"], after, cfg)
    grew = {k: profiling.counters()[k] - before[k] for k in names}
    # the rejected lanes' updates: the Gauss-Newton batch on them alone
    level2 = (mix["pyr2"].img[0], mix["pyr2"].gradx[0], mix["pyr2"].grady[0])
    *_, nit = affine._affine_track_batch(after.aff.img, *level2, after.x,
                                         after.y, after.aff.A, g["reject"],
                                         cfg)
    cap = cfg.affine_max_iterations
    n_cap, n_reject = int(g["cap"].sum()), int(g["reject"].sum())
    assert grew == {"k6.checked_lanes": n_cap + n_reject,
                    "k6.gn_steps": cap * n_cap + int(nit[g["reject"]].sum()),
                    "k6.rejections": n_reject}
    assert bool((out.val[g["cap"]] == 0).all())
    assert bool((out.val[g["reject"]] < 0).all())
    assert bool(out.aff.valid[g["capture"]].all())
    assert not bool(out.aff.valid[g["lost"] | g["dead"] | g["reject"]].any())
