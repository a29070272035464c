"""Rectified-stereo matching and metric depth from the LK tracker
(PyTorch port of ``pyfeaturetrack_tpu/sfm/stereo.py``).

On a rectified pair the correspondence is a pure horizontal shift, so the
pyramidal LK is the stereo matcher: multi-hypothesis guided starts through
K2 (one guided round trip, ``sfm/loop.guided_retrack``, per candidate
disparity), gated by the epipolar constraint (|dy| small), the disparity
range and the round-trip error. Depth is metric: z = fx * baseline / d.
"""

from __future__ import annotations

import numpy as np

from ..config import TrackerConfig, create_config
from ..ops.track import build_track_pyramids
from ..utils.staging import stage_f32
from .geometry import to_host
from .loop import guided_retrack


def stereo_match(img_left, img_right, x, y,
                 cfg: TrackerConfig | None = None,
                 max_disparity: float = 64.0,
                 y_tolerance: float = 0.75,
                 min_disparity: float = 0.25,
                 fb_max_displacement: float = 0.75,
                 hypothesis_stride: float = 10.0, *, device="cuda"):
    """Match left-image features into the right image of a rectified
    pair, on ``device`` ("cuda" unless the caller passes "cpu"; tensors
    stay on their own). Returns (disparity [N], valid [N]) numpy;
    disparity = x_L - x_R.

    LK runs from candidate disparities ``hypothesis_stride`` apart and
    keeps, per feature, the hypothesis with the smallest guided
    round-trip error; matches must then satisfy |y_R - y_L| <=
    ``y_tolerance`` and the disparity range.
    """
    cfg = (cfg or create_config()).validated_window()
    pyr_l = build_track_pyramids(stage_f32(img_left, device), cfg)
    pyr_r = build_track_pyramids(
        stage_f32(img_right, pyr_l.img[0].device), cfg)
    x = np.asarray(to_host(x), np.float32)
    y = np.asarray(to_host(y), np.float32)

    n = x.shape[0]
    best_err = np.full((n,), np.inf)
    best_xr = np.zeros((n,))
    best_yr = np.zeros((n,))
    for d0 in np.arange(0.0, max_disparity + 1e-6, hypothesis_stride):
        xr, yr, _, err = guided_retrack(
            pyr_l, pyr_r, x, y, x - np.float32(d0), y, cfg,
            fb_max_displacement=fb_max_displacement)
        upd = err < best_err
        best_err = np.where(upd, err, best_err)
        best_xr = np.where(upd, xr, best_xr)
        best_yr = np.where(upd, yr, best_yr)

    disparity = x - best_xr
    valid = ((best_err <= fb_max_displacement) &
             (np.abs(best_yr - y) <= y_tolerance) &
             (disparity >= min_disparity) & (disparity <= max_disparity))
    return disparity, valid


def stereo_depth(disparity, fx: float, baseline: float):
    """Metric depth z = fx * baseline / disparity (invalid lanes of a
    gated disparity array should be masked by the caller)."""
    d = np.asarray(disparity, np.float64)
    return fx * baseline / np.maximum(d, 1e-9)


def stereo_triangulate(K, baseline: float, x, y, disparity):
    """Left-camera-frame 3D points [N, 3] from pixel positions and
    disparity — metric scale set by the physical ``baseline``."""
    K = np.asarray(K, np.float64)
    z = stereo_depth(disparity, K[0, 0], baseline)
    X = (np.asarray(x, np.float64) - K[0, 2]) * z / K[0, 0]
    Y = (np.asarray(y, np.float64) - K[1, 2]) * z / K[1, 1]
    return np.stack([X, Y, z], -1)
