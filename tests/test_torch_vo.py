"""The port's monocular visual odometry (``sfm/vo.py``) against the JAX
package on the CPU: tests/test_vo.py's scene with its hyperparameters,
the bootstrap keyframe pair, the keyframe frame list and the events
equal, the same landmarks, keyframe centres within 1e-3 units of JAX's,
and the JAX tests' ATE bars. Also the device route (``device_loop``)
against the host route, the H/E bootstrap selection, the radtan lens
model, the robust preset, a short stereo run and a short loop-closure
run (the scenes of tests/test_camera.py, tests/test_stereo.py and
tests/test_loop.py)."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu.sfm.pipeline import ate_rmse_aligned as jax_ate
from pyfeaturetrack_tpu.sfm.vo import VisualOdometry as JaxVO

from pyfeaturetrack_tpu_torch.sfm.pipeline import ate_rmse_aligned
from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry

import test_camera
import test_loop
import test_stereo
import test_vo

torch.set_num_threads(2)

KW = dict(n_features=120, kf_every=2, window=6, min_parallax_px=10.0)


def run(vo, frames, rights=None):
    for i, f in enumerate(frames):
        if rights is None:
            vo.feed(f)
        else:
            vo.feed(f, right=rights[i])
    return vo


def assert_same_run(got, want, centre_tol=1e-3):
    """The port's run takes JAX's decisions: events, keyframes,
    landmark identities; keyframe centres within ``centre_tol``."""
    assert got.events == want.events
    fg, Rg, _, cg = got.trajectory()
    fw, Rw, _, cw = want.trajectory()
    np.testing.assert_array_equal(fg, fw)
    assert set(got.landmarks) == set(want.landmarks)
    assert got.loops_closed == want.loops_closed
    np.testing.assert_allclose(cg, cw, atol=centre_tol)
    np.testing.assert_allclose(Rg, Rw, atol=centre_tol)


@pytest.fixture(scope="module")
def scene():
    Rs, ts, cs, pts = test_vo._gt_scene()
    return Rs, ts, cs, test_vo._render(Rs, ts, pts)


@pytest.fixture(scope="module")
def runs(scene):
    frames = scene[3]
    return (run(VisualOdometry(test_vo.K, **KW, device="cpu"), frames),
            run(JaxVO(test_vo.K, **KW), frames))


def test_vo_matches_jax(runs, scene):
    got, want = runs
    assert any("bootstrap at" in e for e in got.events)
    assert_same_run(got, want)
    assert len(got.map_points()) == len(want.map_points()) >= 60
    fi, R, _, c = got.trajectory()
    gt = scene[2][fi]
    ate = ate_rmse_aligned(c, gt)
    assert ate < 0.03 * np.linalg.norm(gt[-1] - gt[0])
    assert abs(ate - jax_ate(want.trajectory()[3], gt)) < 1e-3
    for k in range(len(fi)):     # test_vo.py's rotation bar
        assert np.abs(R[k] @ scene[0][fi[k]].T - np.eye(3)).max() < 0.02


def test_device_loop_matches_host_route(runs, scene):
    """device_loop=True (sequence_chain_device per keyframe interval, one
    history pull per keyframe) takes the host route's decisions."""
    host = runs[0]
    dev = run(VisualOdometry(test_vo.K, device_loop=True, **KW,
                             device="cpu"), scene[3])
    assert_same_run(dev, host, centre_tol=1e-5)


def test_auto_bootstrap_matches_jax(scene):
    got = run(VisualOdometry(test_vo.K, bootstrap_model="auto", **KW,
                             device="cpu"), scene[3])
    want = run(JaxVO(test_vo.K, bootstrap_model="auto", **KW), scene[3])
    assert_same_run(got, want)


def test_robust_preset_matches_jax(scene):
    got = run(VisualOdometry(test_vo.K, robust=True, **KW, device="cpu"),
              scene[3])
    want = run(JaxVO(test_vo.K, robust=True, **KW), scene[3])
    assert got._tr.cfg.lighting_insensitive
    assert got._tr.fb_max_displacement == 0.5
    assert_same_run(got, want)


def test_lens_model_vo_matches_jax():
    cs, frames = test_camera._distorted_scene()
    got = run(VisualOdometry(test_camera.K, dist=test_camera.RADTAN, **KW,
                             device="cpu"), frames)
    want = run(JaxVO(test_camera.K, dist=test_camera.RADTAN, **KW), frames)
    assert_same_run(got, want)
    fi, _, _, c = got.trajectory()
    gt = cs[fi]
    assert ate_rmse_aligned(c, gt) < 0.035 * np.linalg.norm(gt[-1] - gt[0])
    with pytest.raises(ValueError):
        VisualOdometry(test_camera.K, dist=test_camera.RADTAN,
                       loop_closure=True, device="cpu")


def test_stereo_vo_metric_trajectory():
    """tests/test_stereo.py's stereo VO scene, shortened to 8 frames:
    metric landmarks from frame 0, the raw (unaligned) error under that
    test's bar, the JAX run's events and keyframes."""
    rng = np.random.default_rng(80)
    n_pts = 300
    pts = np.stack([rng.uniform(-9.0, 9.0, n_pts),
                    rng.uniform(-6.0, 6.0, n_pts),
                    rng.uniform(6.0, 20.0, n_pts)], -1).astype(np.float32)
    amp = rng.uniform(120, 255, n_pts)
    cs = [np.array([0.2 * i, 0.03 * i, 0.08 * i]) for i in range(8)]
    R = np.eye(3, dtype=np.float32)
    lefts, rights = [], []
    for c in cs:
        lefts.append(test_stereo._render(R, (-R @ c).astype(np.float32),
                                         pts, amp))
        c_r = c + np.array([test_stereo.BASELINE, 0, 0])
        rights.append(test_stereo._render(R, (-R @ c_r).astype(np.float32),
                                          pts, amp))
    kw = dict(n_features=120, kf_every=2, window=6,
              stereo_baseline=test_stereo.BASELINE, max_disparity=40.0)
    got = run(VisualOdometry(test_stereo.K, **kw, device="cpu"), lefts,
              rights)
    want = run(JaxVO(test_stereo.K, **kw), lefts, rights)
    assert any("stereo init" in e for e in got.events), got.events
    assert_same_run(got, want)
    fi, _, _, c = got.trajectory()
    err = np.linalg.norm(c - np.stack(cs)[fi], axis=-1)
    travel = float(np.linalg.norm(np.diff(np.stack(cs), axis=0),
                                  axis=-1).sum())
    assert err.max() < 0.03 * travel, (err, got.events)


def test_loop_closure_vo_matches_jax():
    """tests/test_loop.py's rectangular loop: a genuine revisit closes
    (guided re-observation through K2's starts, PnP, the Sim(3)
    correction, global BA) as in the JAX run; ATE under that test's
    bar."""
    Rs, ts, cs, frames = test_loop._loop_scene()
    kw = dict(KW, loop_closure=True, loop_min_gap=6, loop_radius=0.6,
              loop_min_inliers=12)
    got = run(VisualOdometry(test_loop.K, **kw, device="cpu"), frames)
    want = run(JaxVO(test_loop.K, **kw), frames)
    assert got.loops_closed, got.events
    i, j = got.loops_closed[0]
    assert j - i >= 6
    assert_same_run(got, want)
    fi, _, t, _ = got.trajectory()
    travel = float(np.linalg.norm(np.diff(cs, axis=0), axis=-1).sum())
    assert ate_rmse_aligned(t, ts[fi]) < 0.02 * travel


def test_vo_options_refused():
    with pytest.raises(RuntimeError):
        VisualOdometry(test_vo.K, device="cpu").trajectory()
    with pytest.raises(ValueError):
        VisualOdometry(test_vo.K, bootstrap_model="homography", device="cpu")
    with pytest.raises(ValueError):
        VisualOdometry(test_vo.K, stereo_baseline=0.3, device_loop=True,
                       device="cpu")
    with pytest.raises(ValueError):
        VisualOdometry(test_vo.K, stereo_baseline=0.3,
                       device="cpu").feed(np.zeros((64, 64), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VisualOdometry(test_vo.K)       # the card by default
