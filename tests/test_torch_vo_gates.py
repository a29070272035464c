"""The visual odometry's reprojection gate, ``outlier_px`` (sfm/vo.py on
the CPU).

Localization: a mapped track that lands farther than ``outlier_px`` from
its landmark ends (its slot takes a new generation) and the pose is
refined again without it. Mapping: a DLT point joins the map only in
front of every observing camera and within ``outlier_px`` of each pixel it
was solved from. Without the option (the default) every track and every
point in front of its cameras stays, as in the JAX package. Tracks here
are exact projections, with some slid short of their flow, as KLT leaves
a track whose flow outruns its pyramid."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry

torch.set_num_threads(2)

K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]])


def _pose(yaw, c):
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, 0.0, -sy], [0.0, 1.0, 0.0], [sy, 0.0, cy]])
    return R, -R @ np.asarray(c, np.float64)


def _project(R, t, X):
    Y = X @ R.T + t
    return K[0, 0] * Y[:, 0] / Y[:, 2] + K[0, 2], \
        K[1, 1] * Y[:, 1] / Y[:, 2] + K[1, 2]


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                     rng.uniform(6, 14, n)], -1)


def _keyframe(vo, x, y, live):
    vo.kf.append({"frame": len(vo.kf), "x": x, "y": y,
                  "gen": vo.gen.copy(), "live": live, "img": None,
                  "sig": None})


def _localized(slid, **kw):
    n = 60
    X = _points(n)
    vo = VisualOdometry(K, n_features=n, device="cpu", **kw)
    vo.initialized = True
    vo.poses = [_pose(0.0, [0.0, 0.0, 0.0])]
    for s in range(n):
        vo.landmarks[(s, 0)] = X[s]
    R1, t1 = _pose(0.02, [0.1, 0.0, 0.8])
    x, y = _project(R1, t1, X)
    # slid tracks: held a third of the way along their flow
    x0, y0 = _project(*vo.poses[0], X)
    x[:slid] = x0[:slid] + (x[:slid] - x0[:slid]) / 3 + 15.0
    y[:slid] = y0[:slid] + (y[:slid] - y0[:slid]) / 3
    _keyframe(vo, x, y, np.ones(n, bool))
    vo._localize_new_keyframe()
    return vo, R1, t1


@pytest.mark.parametrize("slid", [0, 5, 12])
def test_localization_ends_slid_tracks_and_keeps_the_pose(slid):
    vo, R1, t1 = _localized(slid, outlier_px=4.0)
    R, t = vo.poses[-1]
    np.testing.assert_allclose(R, R1, atol=1e-4)
    np.testing.assert_allclose(t, t1, atol=1e-4)
    w = vo.keyframe_record()["localize"]["w"]
    assert (w[:slid] == 0).all() and (w[slid:] == 1).all()
    np.testing.assert_array_equal(vo.gen[:slid], 1)
    np.testing.assert_array_equal(vo.gen[slid:], 0)
    np.testing.assert_array_equal(vo.kf[-1]["gen"], vo.gen)


def test_without_the_gate_every_track_stays():
    vo, R1, _ = _localized(12)
    w = vo.keyframe_record()["localize"]["w"]
    assert (w == 1).all() and not vo.gen.any()
    # the slid tracks pull the pose off
    assert np.abs(vo.poses[-1][0] - R1).max() > 1e-3


def _mapped(**kw):
    n = 80
    X = _points(n, seed=1)
    vo = VisualOdometry(K, n_features=n, window=3, min_tri_parallax_px=2.0,
                        device="cpu", **kw)
    vo.initialized = True
    poses = [_pose(0.0, [0, 0, 0]), _pose(0.01, [0.2, 0, 1.0]),
             _pose(0.02, [0.4, 0, 2.0])]
    slid = np.zeros(n, bool)
    slid[::8] = True
    for k, (R, t) in enumerate(poses):
        x, y = _project(R, t, X)
        # slid tracks: 20 px off their point at the newest keyframe
        if k == 2:
            y = np.where(slid, y + 20.0, y)
        vo.poses.append((R, t))
        _keyframe(vo, x, y, np.ones(n, bool))
    vo._triangulate_new()
    return vo, X, slid, vo.keyframe_record()["triangulate"]


def test_mapping_keeps_only_points_that_fit_their_rays():
    vo, X, slid, tri = _mapped(outlier_px=4.0)
    assert tri["gate_px"] == 4.0
    np.testing.assert_array_equal(tri["kept"], ~slid)
    assert set(vo.landmarks) == {(s, 0) for s in np.nonzero(~slid)[0]}
    for s in np.nonzero(~slid)[0]:
        np.testing.assert_allclose(vo.landmarks[(s, 0)], X[s], rtol=1e-3)


def test_without_the_gate_every_point_in_front_joins():
    vo, _, slid, tri = _mapped()
    assert tri["gate_px"] == float("inf")
    assert tri["kept"][~slid].all() and tri["kept"][slid].any()
    assert len(vo.landmarks) == tri["kept"].sum()


@pytest.mark.parametrize("bad", [0.0, -1.0])
def test_outlier_px_must_be_positive(bad):
    with pytest.raises(ValueError, match="outlier_px"):
        VisualOdometry(K, outlier_px=bad, device="cpu")
