"""The comparison that decides ``correct``, lane by lane and as a
verdict against limits."""

import numpy as np
import pytest

import run
from checks import klt_steps


def row(x, y, v):
    return (np.asarray(x, np.float64), np.asarray(y, np.float64),
            np.asarray(v, np.int64))


REF = row([10, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 77, -1])


@pytest.mark.parametrize("got,bad", [
    (row([10, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 76, -1]), 0),
    (row([10.009, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 9, -1]), 0),
    (row([10.02, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 9, -1]), 1),
    (row([10, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -2, 9, -1]), 1),
    (row([10, -1, -1, 40, -1], [11, -1, -1, 41, -1], [0, -5, -4, 9, -1]), 1),
    (row([10, 20.5, -1, 41, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 9, -1]), 1),
    (row([10, 20.5, -1, 40, -1], [11, 21.25, -1, 41, -1], [0, 0, -4, 0, -1]), 1),
    (row([10, 20.5, 40, -1, -1], [11, 21.25, 41, -1, -1], [0, 0, 5, -1, -1]), 1),
])
def test_compare_rows(got, bad):
    c = klt_steps.compare_rows(REF, got)
    assert c["lanes"] == 5 and c["bad"] == bad


def test_gaps_of_lanes_both_tracked():
    got = row([10.003, 20.5, -1, 40, -1], [11.004, 21.25, -1, 41, -1],
              [0, -3, -4, 1, -1])
    assert klt_steps.compare_rows(REF, got)["gaps"] == pytest.approx([0.005])


def test_picks_compare_as_sets():
    ref = row([5, 6, 7, -1], [1, 2, 3, -1], [9, 8, 7, -1])
    assert klt_steps.compare_picks(ref, row([7, 5, 6, -1], [3, 1, 2, -1],
                                        [7, 9, 8, -1])) == 0
    assert klt_steps.compare_picks(ref, row([7, 5, 9, -1], [3, 1, 2, -1],
                                        [7, 9, 8, -1])) == 1
    assert klt_steps.compare_picks(ref, row([7, 5, 6, 9], [3, 1, 2, 9],
                                        [7, 9, 8, 1])) == 1


def test_verdict():
    limits = {"start_mismatch": 0.05, "step_mismatch": 0.005,
              "gap_p99_px": 0.001}
    ok, out = run.verdict({"start_mismatch": 0.05, "step_mismatch": 0.0,
                           "gap_p99_px": 1e-4}, limits)
    assert ok and list(out) == list(limits)
    assert out["gap_p99_px"] == {"value": 1e-4, "limit": 0.001}
    ok, _ = run.verdict({"start_mismatch": 0.0, "step_mismatch": 0.006,
                           "gap_p99_px": 1e-4}, limits)
    assert not ok
