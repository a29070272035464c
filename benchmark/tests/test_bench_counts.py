"""The counting model: hand counts at small sizes, and counts that are
functions of shapes and inputs alone (no program import, no state)."""

import subprocess
import sys

import numpy as np
import pytest

import counts
from conftest import BENCH
from reference import klt

KLT = {"window_width": 7, "window_height": 7, "smooth_sigma_fact": 0.1,
       "grad_sigma": 1.0, "pyramid_sigma_fact": 0.9, "subsampling": 2,
       "nPyramidLevels": 2, "borderx": 24, "bordery": 24, "nSkippedPixels": 0,
       "mindist": 10, "image_dtype": "float32"}


@pytest.mark.parametrize("sigma,gauss,deriv", [(1.0, 7, 7), (0.7, 5, 5),
                                               (1.8, 11, 13), (3.6, 21, 25)])
def test_kernel_widths(sigma, gauss, deriv):
    assert counts.kernel_widths(sigma) == (gauss, deriv)
    g, d = klt.kernels(sigma)
    assert (len(g), len(d)) == (gauss, deriv)


def test_k1_hand_count():
    # 8x8 frame, levels (8, 8) and (4, 4); taps 5 (pre-smooth), 7 and 7
    # (gradients), 11 (pyramid)
    nbytes, ops = counts.k1(KLT, 8, 8)
    assert nbytes == 4 * 64 + 3 * 4 * 64 + 3 * 4 * 16 + 4 * 64
    assert ops == (2 * 2 * 5 * 64 + 56 * 64 + 2 * 11 * 8 * 4
                   + 2 * 11 * 4 * 4 + 56 * 16 + 47 * 64)
    half = dict(KLT, image_dtype="bfloat16")
    assert counts.k1(half, 8, 8)[0] == 4 * 64 + 3 * 2 * 80 + 4 * 64


def test_k2_hand_count():
    nbytes, ops = counts.k2(KLT, 10, tracked=3, lost=2)
    assert nbytes == 8 * 6 * 64 * 4 + 10 * 24
    assert ops == 8 * (49 * 31 + 49 * 34 + 12)


def test_k4_hand_count():
    assert counts.lattice(KLT, 60, 60) == (12, 12)
    assert counts.k4(KLT, 60, 60, 10, 2) == (4 * 144 + 12 * 10 + 13 * 10,
                                            144 + 2 * 19 * 19)


def test_k6_k8_hand_counts():
    aff = dict(KLT, affineConsistencyCheck=2, affine_window_width=3,
               affine_window_height=3)
    nbytes, ops = counts.k6(aff, 4, checked=2, iterations=5)
    assert nbytes == 2 * (9 * 4 + 3 * 16 * 4) + 4 * 57
    assert ops == 5 * (9 * (8 + 2 + 6 + 21 + 1 + 4 + 2 * 27) + 2 * 36 * 7) \
        + 2 * 9 * 26
    assert counts.k8(KLT, 4, 5, reached=6, iterations=7) == (
        6 * 4 * 20 + 4 * 2 * 20 + 20 * 16, 6 * 49 * 10 + 7 * (49 * 34 + 12))
    assert counts.k8(KLT, 4, 5, reached=6, iterations=7, one_d=True,
                     coarse=(2, 3)) == (
        4 * 4 * 20 + 4 * 6 + 20 * 12, 6 * 490 + 7 * (49 * 20 + 4) + 20 * 20)


def test_frame_counts_read_the_slots():
    prev = np.array([0, 0, 5, -1, -4, 0], np.int32)
    cur = np.array([0, -3, 0, 7, -1, 9], np.int32)
    got = counts.frame_counts(KLT, 60, 60, prev, cur)
    # live before: lanes 0, 1, 2, 5; tracked after: 0, 2; lost: 1, and 5
    # (lost, then refilled); refilled: 3, 5
    assert got["k2"] == counts.k2(KLT, 6, 2, 2)
    assert got["k4"] == counts.k4(KLT, 60, 60, 6, 2)
    assert got["k1"] == counts.k1(KLT, 60, 60)
    assert counts.frame_counts(KLT, 60, 60, prev, cur) == got


def test_bound_takes_the_larger():
    assert counts.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 67e12 * 2) == pytest.approx(2.0)


def test_counts_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import counts, devtrace; "
            "from checks import klt_steps; from reference import klt; "
            "print(sorted(m for m in "
            "sys.modules if m.split('.')[0].startswith('pyfeaturetrack')))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
