"""The visual odometry's tracing and its frame width (sfm/vo.py on the CPU).

The ``vo.*`` spans and counters: every span the run opens is in
``profiling.SPANS``; a keyframe opens one ``vo.keyframe`` and counts once
under ``vo.keyframes``; each frame's tracking opens one ``vo.track``; the
geometry's spans, ``vo.ba_observations`` and the ``sync.vo_*`` sites count
what the keyframe records hold. And the device route at a 1241-column
frame (the KITTI width, levels of 620, 310 and 155 columns) takes the host
route's decisions, as tests/test_torch_vo.py holds it at 320 columns."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyfeaturetrack_tpu_torch import create_config
from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry
from pyfeaturetrack_tpu_torch.utils import profiling
from pyfeaturetrack_tpu_torch.utils.synthscene import (corridor_scene,
                                                       render_blobs)

torch.set_num_threads(2)

VO_SPANS = ("vo.track", "vo.keyframe", "vo.localize", "vo.triangulate",
            "vo.ba")


def _drive(n, h, w, n_features, **kw):
    K, Rs, ts, cs, pts = corridor_scene(n, h, w, seed=5)
    return K, render_blobs(K, Rs, ts, pts, h, w), kw | dict(
        n_features=n_features, kf_every=2, window=6, min_parallax_px=10.0)


@pytest.fixture(scope="module")
def traced():
    """A 24-frame device-route drive at 240x320 under the profiler: (vo,
    ranges by name, counter deltas, keyframe records)."""
    K, frames, kw = _drive(24, 240, 320, 100)
    vo = VisualOdometry(K, device_loop=True, device="cpu", **kw)
    before = profiling.counters()
    records = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in frames:
            kfs = vo.n_frames
            vo.feed(f)
            rec = vo.keyframe_record()
            if rec.get("frame") == kfs and (not records
                                            or records[-1] is not rec):
                records.append(rec)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    ranges = collections.Counter(e.name for e in prof.events()
                                 if e.name.startswith("vo."))
    return vo, frames, ranges, delta, records


def test_vo_spans_are_listed(traced):
    _, _, ranges, _, _ = traced
    assert set(ranges) == set(VO_SPANS)
    assert set(VO_SPANS) <= set(profiling.SPANS)
    for name in VO_SPANS:
        assert profiling.SPANS[name][0] == "visual odometry"


def test_one_keyframe_span_and_count_a_keyframe(traced):
    vo, frames, ranges, delta, records = traced
    keyframes = 1 + (len(frames) - 1) // vo.kf_every
    assert len(records) == keyframes
    assert ranges["vo.keyframe"] == delta["vo.keyframes"] == keyframes
    assert ranges["vo.track"] == len(frames)
    # the device route pulls once a keyframe
    assert delta["sync.vo_pull"] == keyframes


def test_geometry_spans_and_counters_match_the_records(traced):
    vo, _, ranges, delta, records = traced
    assert vo.initialized
    placed = [r for r in records if "localize" in r]
    assert placed and ranges["vo.localize"] == len(placed)
    assert ranges["vo.triangulate"] == ranges["vo.ba"] == len(placed)
    assert delta["sync.vo_pose"] == len(placed)
    assert delta["sync.vo_tri"] == sum("triangulate" in r for r in records)
    bas = [r["ba"] for r in records if "ba" in r]
    assert delta["sync.vo_ba"] == len(bas) > 0
    assert delta["vo.ba_observations"] == sum(
        int((b["problem"].w > 0).sum()) for b in bas)
    # the BA's own waits: three groupings and the solves' check a call
    assert delta["sync.ba_segments"] == 3 * len(bas)
    assert delta["sync.ba_info"] == len(bas)
    for r in records:
        hist = r.get("track", {}).get("history")
        if hist is not None:
            assert all(h.shape == (vo.kf_every, vo.n_features) for h in hist)


def test_keyframe_record_holds_the_steps_results(traced):
    """The record's results are what the VO kept: the localized pose before
    the BA, the BA's output before the scale re-anchor (same rotations)."""
    vo, _, _, _, records = traced
    last = records[-1]
    R = last["ba"]["R"].numpy()
    np.testing.assert_allclose(R[-1], vo.poses[-1][0], atol=1e-6)
    loc = last["localize"]
    assert loc["X"].shape[0] == loc["uv"].shape[0] == loc["w"].shape[0]
    tri = last.get("triangulate")
    if tri is not None:
        assert tri["X"].shape[0] == tri["uvs"].shape[0] == tri["kept"].size


@pytest.mark.parametrize("n_features", [150, 240])
def test_device_loop_matches_host_route_at_kitti_width(n_features):
    """At 376x1241 the device route (K1 over four widths down to 155
    columns at subsampling 2, sequence_chain_device per interval) takes
    the host route's decisions: events, keyframes, landmark identities;
    centres within 1e-5."""
    K, frames, kw = _drive(24, 376, 1241, n_features)
    cfg = create_config(nPyramidLevels=4, subsampling=2)
    host = VisualOdometry(K, cfg, device="cpu", **kw)
    dev = VisualOdometry(K, cfg, device_loop=True, device="cpu", **kw)
    for f in frames:
        host.feed(f)
        dev.feed(f)
    assert host.initialized and any("bootstrap at" in e for e in host.events)
    assert dev.events == host.events
    fh, Rh, _, ch = host.trajectory()
    fd, Rd, _, cd = dev.trajectory()
    np.testing.assert_array_equal(fd, fh)
    assert set(dev.landmarks) == set(host.landmarks)
    np.testing.assert_allclose(cd, ch, atol=1e-5)
    np.testing.assert_allclose(Rd, Rh, atol=1e-5)
