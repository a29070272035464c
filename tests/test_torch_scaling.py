"""The port's collective census (``parallel/scaling.collective_census``,
read from the combine layer's record) and weak-scaling harness, on
in-process splits on the CPU: the claims of tests/test_scaling_predict.py
for the port's sharded programs. A tracking step's only collective is its
output gather, plus the refill's feature gather when the feature axis has
more than one rank; a bundle adjustment combines the camera system once
per iteration (and gathers X once); the dense paths gather each level's
bands once."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu_torch.parallel import (collective_census,
                                               measure_scaling, sharding,
                                               split_mesh)

import test_torch_multihost as mh

CPU = "cpu"


def census_of(case, shape):
    fn, names = mh.CASES[case]
    _, c = collective_census(fn, split_mesh(shape, names, CPU))
    return c


@pytest.mark.parametrize("shape,outputs", [((1, 1), 0), ((4, 1), 1),
                                           ((1, 4), 1), ((2, 2), 2)])
def test_tracking_step_gathers_only_its_output(shape, outputs):
    c = census_of("track", shape)
    assert set(c["by_label"]) <= {"output"}
    assert c.get("gather", {"count": 0})["count"] == outputs
    assert "sum" not in c
    if outputs:
        # the (x, y, val) table, never an image: 3 x B x N x 4 bytes at most
        assert max(r["bytes"] for r in c["records"]) == 3 * 8 * 32 * 4


@pytest.mark.parametrize("shape,refill", [((4, 1), 0), ((1, 4), 1),
                                          ((2, 2), 1)])
def test_full_step_adds_the_refill_gather_over_features(shape, refill):
    c = census_of("full", shape)
    assert c["by_label"].get("refill", {"count": 0})["count"] == refill
    n_out = int(shape[0] > 1)
    assert c["by_label"].get("output", {"count": 0})["count"] == n_out
    assert set(c) - {"by_label", "total_bytes", "records"} <= {"gather"}
    for r in c["records"]:
        assert r["axis"] == ("feature" if r["label"] == "refill"
                             else "frame")


@pytest.mark.parametrize("case", ["ba", "windowed_dense", "windowed_cg"])
def test_ba_combines_the_camera_system_once_per_iteration(case):
    """3 iterations: three rank-order sums of the camera system, one X
    gather, nothing else. The dense BA's combine is 4 ranks x (U, b_c,
    S_red, b_red, cost) of 4 cameras."""
    c = census_of(case, (4,))
    assert c["sum"]["count"] == 3
    assert c["by_label"]["camera_system"]["count"] == 3
    assert c["by_label"]["output"]["count"] == 1
    assert len(c["records"]) == 4
    if case == "ba":
        C = 4
        per_rank = C * 36 + C * 6 + (6 * C) ** 2 + C * 6 + 1
        assert c["by_label"]["camera_system"]["bytes"] == 3 * 4 * per_rank * 4


@pytest.mark.parametrize("case", ["flow", "disparity"])
def test_dense_paths_gather_each_level_once(case):
    c = census_of(case, (4,))
    levels = mh.track_cfg().nPyramidLevels
    assert c["by_label"] == {"level": c["by_label"]["level"]}
    assert c["by_label"]["level"]["count"] == levels


@pytest.mark.parametrize("case", ["serving", "chunks"])
def test_streams_and_chunks_gather_once(case):
    c = census_of(case, (4, 1))
    assert c["gather"]["count"] == 1 and set(c["by_label"]) == {"output"}


def test_one_rank_runs_no_collective():
    for case, shape in (("track", (1, 1)), ("full", (1, 1)), ("flow", (1,)),
                        ("ba", (1,))):
        assert census_of(case, shape)["records"] == []


def test_measure_scaling_structure():
    out = measure_scaling(device_counts=[1, 2], image_shape=(64, 96),
                          n_features=16, iters=1, device=CPU)
    assert out["device_counts"] == [1, 2]
    assert set(out["seconds_per_step"]) == {1, 2}
    assert out["efficiency_vs_smallest"][1] == 1.0
    assert all(s > 0 for s in out["seconds_per_step"].values())
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            measure_scaling([1], image_shape=(64, 96), n_features=16,
                            iters=1)


def test_census_resets_per_call():
    sharding.census.append({"kind": "gather", "label": "stale", "bytes": 1})
    c = census_of("track", (2, 1))
    assert "stale" not in c["by_label"]
    assert np.isclose(c["total_bytes"], 3 * 8 * 32 * 4)
