"""The device counters of K2, K4 and K6 and the captured chain's counters,
on the card. Every test is marked ``gpu`` and skips where torch sees no CUDA
device; on a GPU machine run them (no JAX needed) with

    python -m pytest --noconftest tests/test_torch_counters_cuda.py -q

K2's Gauss-Newton steps lie between the (lane, level) pairs it entered
and ``max_iterations`` times those; K4's refill acceptances equal the
slots it filled, and its rescans match a lattice built to hold a known
number; K6's affine stage counts, on a lane mix of known counts
(``tests/_affine_lanes.py``), the lanes it checked, their Gauss-Newton
updates and the lanes it rejected, as its plain version does; counting
changes no output bit (the launch with no counter buffer is the one
before the counters); ten chains of one shape are one capture and ten
replays, and a replay adds what the same steps add when run one by one
(config 3's too, with the affine stage)."""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.models import device_sequence
from pyfeaturetrack_tpu_torch.models.device_sequence import (
    select_step_device, sequence_chain_device, sequence_step_device,
    track_sequence_device)
from pyfeaturetrack_tpu_torch.ops import cuda_lk, cuda_select
from pyfeaturetrack_tpu_torch.ops.select_device import select_features_device
from pyfeaturetrack_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _texture(h, w, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (h + 4, w + 4))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = sum(c * np.roll(img, s - 2, axis=axis) for s, c in enumerate(k))
    return np.floor(img[2:-2, 2:-2]).astype(np.float32)


def _pan(n, h=480, w=640, shift=3, seed=4):
    base = _texture(h, w + shift * n, seed)
    return [base[:, shift * i:shift * i + w].copy() for i in range(n)]


def _device_counts() -> dict:
    got = profiling.counters()
    return {k: got[k] for k in profiling.DEVICE_COUNTERS}


def _grew(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _track_inputs(dev, cfg, n=1000):
    f0, f1 = _pan(2)
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(f, device=dev), cfg)
              for f in (f0, f1))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.uniform(20, 620, n), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(20, 460, n), dtype=torch.float32, device=dev)
    val = torch.tensor(np.where(rng.uniform(size=n) < 0.2, -1, 0),
                       dtype=torch.int32, device=dev)
    return p1, p2, x, y, val


@pytest.mark.parametrize("levels,sub", [(2, 4), (4, 2)])
def test_k2_counts_steps_and_lane_levels(dev, levels, sub):
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub)
    p1, p2, x, y, val = _track_inputs(dev, cfg)
    before = _device_counts()
    cuda_lk.track_pyramid(p1, p2, x, y, val, cfg)
    got = _grew(before, _device_counts())
    live = int((val >= 0).sum())
    assert live <= got["k2.lane_levels"] <= live * levels
    assert (got["k2.lane_levels"] <= got["k2.gn_steps"]
            <= cfg.max_iterations * got["k2.lane_levels"])
    assert got["k4.refill_acceptances"] == got["k4.refill_rescans"] == 0


def test_k4_counts_refill_acceptances(dev):
    """A refill's acceptances are the slots it filled; an initial selection
    adds nothing."""
    cfg = tpft.create_config()
    img = torch.tensor(_pan(1)[0], device=dev)
    n = 1000
    none = (torch.full((n,), -1.0, device=dev),
            torch.full((n,), -1.0, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    before = _device_counts()
    x, y, val, filled, _ = select_features_device(img, *none, cfg,
                                                  replacing=False)
    assert _grew(before, _device_counts())["k4.refill_acceptances"] == 0
    assert bool(filled.any())
    lost = torch.tensor(np.random.default_rng(2).uniform(size=n) < 0.1,
                        device=dev)
    val = torch.where(lost, -1, val)
    before = _device_counts()
    *_, filled, _ = select_features_device(img, x, y, val, cfg,
                                           replacing=True)
    got = _grew(before, _device_counts())
    assert got["k4.refill_acceptances"] == int(filled.sum()) > 0
    # each acceptance rescans at least its own segment, whose maximum it was
    assert got["k4.refill_rescans"] >= got["k4.refill_acceptances"]
    assert got["k2.gn_steps"] == got["k2.lane_levels"] == 0


def test_k4_counts_rescans_on_a_known_lattice(dev):
    """A 64 x 64 lattice (segments of 32 columns) with four candidates and
    boxes of radius 2: A's box holds A's segment maximum and that of B,
    weaker, which it suppresses; C's and D's, in one row but in different
    segments, hold their own. Three acceptances, four rescans."""
    cells = {(10, 5): 100, (12, 7): 50, (40, 40): 80, (40, 20): 70}
    eig = torch.zeros((64, 64), dtype=torch.int32)
    for (r, c), v in cells.items():
        eig[r, c] = v
    n = 8
    x = torch.full((n,), -1.0, device=dev)
    y = torch.full((n,), -1.0, device=dev)
    val = torch.full((n,), -1, dtype=torch.int32, device=dev)
    before = _device_counts()
    fx, fy, _, filled = cuda_select.select_from_eig(
        eig.to(dev), x, y, val, (0, 0, 1, 64, 64), min_eig=1, radius=-1,
        dg=2, replacing=True)
    got = _grew(before, _device_counts())
    assert sorted(zip(fy[filled].tolist(), fx[filled].tolist())) == [
        (10, 5), (40, 20), (40, 40)]
    assert got["k4.refill_acceptances"] == 3
    assert got["k4.refill_rescans"] == 4


def test_counting_changes_no_output_bit(dev, monkeypatch):
    """K2's track call and K4's refill with the counter buffer and without
    one (null: nothing counted) give the same bits."""
    cfg = tpft.create_config()
    p1, p2, x, y, val = _track_inputs(dev, cfg)
    img = torch.tensor(_pan(2)[1], device=dev)

    def both():
        out = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg)
        return (*out, *select_features_device(img, *out, cfg,
                                              replacing=True)[:4])

    counted = both()
    before = _device_counts()
    monkeypatch.setattr(profiling, "device_counters", lambda d: None)
    uncounted = both()
    monkeypatch.undo()
    assert _device_counts() == before
    for a, b in zip(counted, uncounted):
        assert torch.equal(a, b)


def test_ten_chains_one_capture_ten_replays(dev, monkeypatch):
    monkeypatch.setattr(device_sequence, "_GRAPHS", OrderedDict())
    cfg = tpft.create_config()
    frames = _pan(41, h=120, w=160)
    before = profiling.counters()
    track_sequence_device(frames, cfg, n_features=37, chain=4, device=dev)
    after = profiling.counters()
    grew = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("chain.captures", "chain.replays", "chain.state_loads",
                      "chain.evictions")}
    assert grew == {"chain.captures": 1, "chain.replays": 10,
                    "chain.state_loads": 1, "chain.evictions": 0}


def test_a_replay_adds_what_its_steps_add(dev):
    """The captured chain's K2 and K4 launches count on replay as the same
    steps run one by one do, from the same state over the same frames."""
    cfg = tpft.create_config()
    frames = [torch.tensor(f, device=dev) for f in _pan(5, h=240, w=320)]
    pyr, x, y, val, _, _ = select_step_device(frames[0], cfg, 300)
    # the first call captures (its warm-up step launches too), then replays
    sequence_chain_device(pyr, frames[1:], x, y, val, cfg)
    before = _device_counts()
    sequence_chain_device(pyr, frames[1:], x, y, val, cfg)
    chained = _grew(before, _device_counts())
    before = _device_counts()
    for f in frames[1:]:
        pyr, x, y, val, *_ = sequence_step_device(pyr, f, x, y, val, cfg)
    stepped = _grew(before, _device_counts())
    assert chained == stepped
    assert chained["k2.lane_levels"] > 0


K6_COUNTERS = ("k6.checked_lanes", "k6.gn_steps", "k6.rejections")


def _k6_stage(mix):
    from pyfeaturetrack_tpu_torch.ops import affine
    return affine.affine_consistency_check(mix["pyr1"], mix["pyr2"],
                                           mix["before"], mix["after"],
                                           mix["cfg"])


def test_k6_counts_a_known_lane_mix(dev):
    """Checked lanes: the lanes tracked with a template; updates: the
    iteration cap for each lane that passes, plus the rejected lanes'; the
    rejected lanes; the same counts as the plain stage on the card."""
    from _affine_lanes import lane_mix
    from pyfeaturetrack_tpu_torch.ops import affine
    from pyfeaturetrack_tpu_torch.utils import cuda
    mix = lane_mix(dev)
    cfg, g, after = mix["cfg"], mix["groups"], mix["after"]
    before = _device_counts()
    out = _k6_stage(mix)
    got = _grew(before, _device_counts())
    before = _device_counts()
    with cuda.reference_path():
        plain = _k6_stage(mix)
    assert _grew(before, _device_counts()) == got
    level2 = (mix["pyr2"].img[0], mix["pyr2"].gradx[0], mix["pyr2"].grady[0])
    *_, nit = affine._affine_track_batch(after.aff.img, *level2, after.x,
                                         after.y, after.aff.A, g["reject"],
                                         cfg)
    n_cap, n_reject = int(g["cap"].sum()), int(g["reject"].sum())
    assert {k: got[k] for k in K6_COUNTERS} == {
        "k6.checked_lanes": n_cap + n_reject,
        "k6.gn_steps": cfg.affine_max_iterations * n_cap
        + int(nit[g["reject"]].sum()),
        "k6.rejections": n_reject}
    assert got["k2.gn_steps"] == got["k4.refill_acceptances"] == 0
    assert bool((out.val[g["cap"]] == 0).all())
    assert bool((out.val[g["reject"]] < 0).all())
    for a, b in zip((out.x, out.y, out.val, *out.aff),
                    (plain.x, plain.y, plain.val, *plain.aff)):
        assert torch.equal(a, b)


def test_k6_counting_changes_no_output_bit(dev, monkeypatch):
    """The affine stage with the counter buffer and without one (null:
    nothing counted) gives the same bits."""
    from _affine_lanes import lane_mix
    mix = lane_mix(dev)
    counted = _k6_stage(mix)
    before = _device_counts()
    monkeypatch.setattr(profiling, "device_counters", lambda d: None)
    uncounted = _k6_stage(mix)
    monkeypatch.undo()
    assert _device_counts() == before
    for a, b in zip((counted.x, counted.y, counted.val, *counted.aff),
                    (uncounted.x, uncounted.y, uncounted.val,
                     *uncounted.aff)):
        assert torch.equal(a, b)


def test_a_config3_replay_adds_what_its_steps_add(dev):
    """With the affine stage in the chain (config 3), a replay adds to K2's,
    K4's and K6's counters what the same steps add run one by one."""
    cfg = tpft.create_config(affineConsistencyCheck=2, nPyramidLevels=3,
                             subsampling=2).replace(sequentialMode=True)
    frames = [torch.tensor(f, device=dev) for f in _pan(9, h=240, w=320)]
    pyr, x, y, val, aff, _ = select_step_device(frames[0], cfg, 300)
    # frames 1-4 capture templates; the chain over 5-8 checks them
    for f in frames[1:5]:
        pyr, x, y, val, aff, *_ = sequence_step_device(pyr, f, x, y, val, cfg,
                                                       aff=aff)
    sequence_chain_device(pyr, frames[5:], x, y, val, cfg, aff=aff)
    before = _device_counts()
    sequence_chain_device(pyr, frames[5:], x, y, val, cfg, aff=aff)
    chained = _grew(before, _device_counts())
    before = _device_counts()
    for f in frames[5:]:
        pyr, x, y, val, aff, *_ = sequence_step_device(pyr, f, x, y, val, cfg,
                                                       aff=aff)
    stepped = _grew(before, _device_counts())
    assert chained == stepped
    assert chained["k6.checked_lanes"] > 0 and chained["k2.lane_levels"] > 0
